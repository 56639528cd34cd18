"""Height-sharded tokenizer inference (``vqvae_tpu_torch/parallel/spatial.py``)
on the CPU: two gloo ranks, spawned once for the module with
``torch.multiprocessing`` and joined through a ``file://`` store, each
holding half the rows of every image, against the JAX package's
``make_spatial_apply`` on a 2-device mesh and against one port process on
whole images (32^2, channels 32, multipliers [1, 2], N = 32, D = 8; the
JAX weights converted):

- ``get_tokens`` (standard, and gumbel's deterministic tokens) and the
  token-export CLI under ``--spatial``: equal to JAX's and to one process's,
  exactly, on every rank;
- ``quantize``: gathered on every rank, within rtol 1e-5 / atol 1e-5 of
  JAX's, and of one process's;
- ``reconstruct`` and ``reconstruct_from_tokens``: each rank's slab holds
  its rows of JAX's images and of one process's, within rtol 1e-5 / atol
  1e-5 (the two ranks' GroupNorm sums add in another order);
- an image height that does not divide by ranks x 2**levels raises JAX's
  message on every rank;
- without a group the function is the plain method, bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import yaml

from vqvae_tpu_torch.cli import tokenize_dataset as cli_tokenize
from vqvae_tpu_torch.config import parse_config
from vqvae_tpu_torch.data.packed import write_packed
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.parallel import dist
from vqvae_tpu_torch.parallel.spatial import make_spatial_apply, shard_rows
from vqvae_tpu_torch.train.loop import Trainer
from vqvae_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(1)

WORLD, IMG, NRB, LEVELS = 2, 32, 1, 2
RTOL = ATOL = 1e-5
Q_PARAMS = {"standard": {"commitment_cost": 0.25},
            "gumbel": {"straight_through": False, "temp": 1.0, "kl_cost": 0.01}}


def _raw(q_type: str) -> dict:
    return {"image_size": IMG,
            "autoencoder": {"channels": 32, "num_res_blocks": NRB, "channel_multipliers": [1, 2]},
            "quantizer": {"type": q_type, "num_embeddings": 32, "embedding_dim": 8,
                          "reinit_every_n_epochs": None, "params": Q_PARAMS[q_type]},
            "training": {"cumulative_bs": 4, "base_lr": 1e-4, "betas": [0.0, 0.99],
                         "eps": 1e-8, "weight_decay": 1e-4, "decay_epochs": 2,
                         "max_epochs": 1}}


def _images() -> np.ndarray:
    return np.random.RandomState(21).rand(2, IMG, IMG, 3).astype(np.float32)


def _model(q_type: str, weights: dict) -> VQVAE:
    model = VQVAE.from_config(parse_config(_raw(q_type)), device="cpu")
    model.load_state_dict(weights, strict=True)
    return model


def _port_outputs(weights: dict) -> dict:
    """Every sharded method on this process's rows (the whole images
    without a group)."""
    images = shard_rows(torch.from_numpy(_images()))
    out = {}
    for q_type in Q_PARAMS:
        kw = {"deterministic": True} if q_type == "gumbel" else {}
        out[f"tokens_{q_type}"] = make_spatial_apply(
            _model(q_type, weights[q_type]), "get_tokens", **kw)(images)
    model = _model("standard", weights["standard"])
    out["quantize"] = make_spatial_apply(model, "quantize")(images)
    out["reconstruct"] = make_spatial_apply(model, "reconstruct")(images)
    tokens = shard_rows(out["tokens_standard"], dim=1)
    out["from_tokens"] = make_spatial_apply(model, "reconstruct_from_tokens")(tokens)
    return out


def _cli(root, spatial: bool, out: str) -> None:
    cli_tokenize.main(["--params_file", str(root / "standard.yaml"), "--loading_path",
                       str(root / "port" / "last"), "--dataset_path", str(root / "data"),
                       "--splits", "train", "--batch_size", "2", "--dataloader", "packed",
                       "--workers", "1", "--seed", "0", "--output_folder", str(root / out),
                       "--device", "cpu", *(["--spatial"] if spatial else [])])


def _worker(rank: int, world: int, root: str):
    from pathlib import Path
    torch.set_num_threads(1)
    root = Path(root)
    dist.init_distributed("cpu", rank=rank, world_size=world,
                          init_method=f"file://{root / 'store'}")
    try:
        out = {"world": dist.world(), **_port_outputs(torch.load(root / "weights.pt"))}
        fn = make_spatial_apply(_model("standard", torch.load(root / "weights.pt")["standard"]))
        try:
            fn(torch.zeros(1, 36 // world, IMG, 3))
        except ValueError as exc:
            out["refusal"] = str(exc)
        _cli(root, True, "cli_spatial")
        out["group_kept"] = dist.world()
        torch.save(out, root / f"rank{rank}.pt")
    finally:
        dist.shutdown()


def _jax_outputs():
    """JAX's ``make_spatial_apply`` on 2 devices, and its weights in the
    port's layout."""
    import jax
    import jax.numpy as jnp

    from vqvae_tpu.config import parse_config as jax_parse_config
    from vqvae_tpu.models.vqvae import VQVAE as JaxVQVAE, model_rngs
    from vqvae_tpu.parallel.mesh import create_mesh
    from vqvae_tpu.parallel.spatial import make_spatial_apply as jax_spatial
    from vqvae_tpu_torch.utils.convert import convert_vqvae_variables

    mesh = create_mesh(("data",), devices=jax.devices()[:WORLD])
    images = jnp.asarray(_images())
    out, weights, models = {}, {}, {}
    for q_type in Q_PARAMS:
        model = JaxVQVAE.from_config(jax_parse_config(_raw(q_type)))
        variables = jax.tree.map(np.array, dict(model.init(
            model_rngs(5, q_type), jnp.zeros((1, IMG, IMG, 3)), train=False)))
        weights[q_type] = convert_vqvae_variables(variables, NRB, LEVELS)
        models[q_type] = (model, variables)
        kw = {"deterministic": True} if q_type == "gumbel" else {}
        out[f"tokens_{q_type}"] = np.asarray(
            jax_spatial(model, variables, mesh, "get_tokens", **kw)(images))
    model, variables = models["standard"]
    for method in ("quantize", "reconstruct"):
        out[method] = np.asarray(jax_spatial(model, variables, mesh, method)(images))
    out["from_tokens"] = np.asarray(jax_spatial(model, variables, mesh, "reconstruct_from_tokens")(
        jnp.asarray(out["tokens_standard"])))
    try:
        jax_spatial(model, variables, mesh, "get_tokens")(jnp.zeros((1, 36, IMG, 3)))
    except ValueError as exc:
        out["refusal"] = str(exc)
    return out, weights


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial")
    jax_out, weights = _jax_outputs()
    torch.save(weights, root / "weights.pt")
    # the CLI's inputs: a port snapshot of the standard weights, 3 packed images
    (root / "standard.yaml").write_text(yaml.safe_dump(_raw("standard")))
    rs = np.random.RandomState(22)
    (root / "data").mkdir()
    write_packed(str(root / "data" / "train.pack"),
                 (rs.randint(0, 256, (IMG, IMG, 3)).astype(np.uint8) for _ in range(3)), IMG)
    state = Trainer(parse_config(_raw("standard")), learning_rate=1e-4, seed=0,
                    steps_per_epoch=1, device="cpu").init_state()
    state.model.load_state_dict(weights["standard"], strict=True)
    CheckpointManager(str(root), "port").save(state, 0)
    ctx = mp.spawn(_worker, args=(WORLD, str(root)), nprocs=WORLD, join=False)
    one = _port_outputs(weights)
    _cli(root, False, "cli_plain")
    while not ctx.join():
        pass
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"jax": jax_out, "one": one, "plain": _plain_outputs(weights), "ranks": ranks,
            "root": root}


def _rows(a, rank: int):
    """Rank ``rank``'s rows of NHWC images."""
    h = a.shape[1] // WORLD
    return np.asarray(a)[:, rank * h:(rank + 1) * h]


def test_ranks_joined_one_group(runs):
    assert [r["world"] for r in runs["ranks"]] == [(0, WORLD), (1, WORLD)]
    assert [r["group_kept"] for r in runs["ranks"]] == [(0, WORLD), (1, WORLD)]


@pytest.mark.parametrize("q_type", list(Q_PARAMS))
def test_tokens_equal_jax_and_one_process(runs, q_type):
    key = f"tokens_{q_type}"
    want = runs["jax"][key]
    assert want.shape == (2, (IMG // 2 ** LEVELS) ** 2) and len(np.unique(want)) > 1
    np.testing.assert_array_equal(runs["one"][key].numpy(), want)
    for r in runs["ranks"]:
        np.testing.assert_array_equal(r[key].numpy(), want)


def test_quantize_gathers_jaxs_latents(runs):
    want = runs["jax"]["quantize"]
    np.testing.assert_allclose(runs["one"]["quantize"].numpy(), want, rtol=RTOL, atol=ATOL)
    for r in runs["ranks"]:
        assert r["quantize"].shape == want.shape
        np.testing.assert_allclose(r["quantize"].numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", ["reconstruct", "from_tokens"])
def test_images_stay_each_ranks_slab(runs, method):
    want = runs["jax"][method]
    assert want.shape == (2, IMG, IMG, 3)
    np.testing.assert_allclose(runs["one"][method].numpy(), want, rtol=RTOL, atol=ATOL)
    for rank, r in enumerate(runs["ranks"]):
        assert r[method].shape == (2, IMG // WORLD, IMG, 3)
        np.testing.assert_allclose(r[method].numpy(), _rows(want, rank), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r[method].numpy(), _rows(runs["one"][method], rank),
                                   rtol=RTOL, atol=ATOL)


def test_unaligned_height_raises_jaxs_message(runs):
    want = runs["jax"]["refusal"]
    assert "must be divisible by n_shards * 2**levels = 2 * 4 = 8" in want
    assert [r.get("refusal") for r in runs["ranks"]] == [want] * WORLD


def test_spatial_cli_writes_the_plain_runs_tokens(runs):
    root = runs["root"]
    got = np.load(root / "cli_spatial" / "train_tokens.npy")
    np.testing.assert_array_equal(got, np.load(root / "cli_plain" / "train_tokens.npy"))
    assert got.shape == (3, (IMG // 2 ** LEVELS) ** 2)
    assert (root / "cli_spatial" / "manifest.json").read_text() == (
        root / "cli_plain" / "manifest.json").read_text()


def _plain_outputs(weights: dict) -> dict:
    """The plain methods on whole images."""
    model = _model("standard", weights["standard"])
    x = torch.from_numpy(_images())
    tokens = model.get_tokens(x)
    return {"tokens_standard": tokens, "quantize": model.quantize(x),
            "reconstruct": model.reconstruct(x),
            "from_tokens": model.reconstruct_from_tokens(tokens)}


@pytest.mark.parametrize("key", ["tokens_standard", "quantize", "reconstruct", "from_tokens"])
def test_without_a_group_it_is_the_plain_method(runs, key):
    assert torch.equal(runs["one"][key], runs["plain"][key])
