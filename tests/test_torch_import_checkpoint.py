"""Checkpoints made elsewhere, brought into the port
(``utils/torch_import.py``, ``cli/import_torch_checkpoint.py``,
``tools/export_jax_checkpoint.py`` + ``cli/import_jax_checkpoint.py``), on
the CPU, for the four quantizers (32^2 images, channels 32, multipliers
[1, 2], N = 32, D = 8):

- The reference layout without the reference: JAX-initialised variables V
  go into the port's VQVAE (``utils/convert.py``); its ``state_dict`` is the
  LightningModule's (the reference VQVAE holds ``encoder``, ``decoder``,
  ``quantizer`` and ``criterion``), and the JAX package's own converter
  (``vqvae_tpu/utils/torch_convert.py`` ``convert_vqvae_state_dict``) turns
  it back into V leaf for leaf, exactly.
- That state_dict as a Lightning ``.ckpt`` with a ``criterion.*`` entry goes
  through the import CLI and ``restore_for_eval``: the port's tokens equal
  JAX's exactly and its reconstructions agree within rtol 1e-5 / atol 1e-5
  (gumbel: the deterministic tokens and ``reconstruct_from_tokens``; its
  ``reconstruct`` draws noise).
- A JAX eval snapshot (``save_eval_checkpoint``, each quantizer) and a JAX
  ``CheckpointManager`` training snapshot (EMA, its ``vq_state`` moved off
  its initial values, with an optimizer state) go through the two-step
  export / import to the same result and keep their ``step``.
- A missing, extra or misshapen key raises, naming it, on both routes.
- The importer's template is the model the port builds, key for key and
  shape for shape, for every ``example_confs/*.yaml`` (the taming layout
  among them), and a tiny taming-layout model's own ``state_dict`` goes
  through the import CLI unchanged.
"""

import functools
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from vqvae_tpu.config import parse_config as jax_parse_config
from vqvae_tpu.models.vqvae import VQVAE as JaxVQVAE, model_rngs
from vqvae_tpu.train.state import create_train_state
from vqvae_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from vqvae_tpu.utils.checkpoint import save_eval_checkpoint as jax_save_eval_checkpoint
from vqvae_tpu.utils.torch_convert import convert_vqvae_state_dict as jax_convert
from vqvae_tpu_torch.cli import import_jax_checkpoint, import_torch_checkpoint
from vqvae_tpu_torch.config import load_config, parse_config
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.train.loop import Trainer
from vqvae_tpu_torch.utils.checkpoint import restore_for_eval
from vqvae_tpu_torch.utils.convert import convert_vqvae_variables
from vqvae_tpu_torch.utils.torch_import import vqvae_template

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
IMG, NRB, LEVELS = 32, 1, 2
Q_PARAMS = {
    "standard": {"commitment_cost": 0.25},
    "ema": {"commitment_cost": 0.25, "decay": 0.95, "epsilon": 1e-5},
    "gumbel": {"straight_through": False, "temp": 1.0, "kl_cost": 0.01},
    "entropy": {"ent_loss_ratio": 0.1, "ent_temperature": 0.01, "ent_loss_type": "softmax",
                "commitment_cost": 0.25},
}
Q_TYPES = tuple(Q_PARAMS)
RTOL = ATOL = 1e-5


def _raw(q_type: str) -> dict:
    return {"image_size": IMG,
            "autoencoder": {"channels": 32, "num_res_blocks": NRB, "channel_multipliers": [1, 2]},
            "quantizer": {"type": q_type, "num_embeddings": 32, "embedding_dim": 8,
                          "reinit_every_n_epochs": None, "params": Q_PARAMS[q_type]},
            "training": {"cumulative_bs": 4, "base_lr": 1e-4, "betas": [0.0, 0.99],
                         "eps": 1e-8, "weight_decay": 1e-4, "decay_epochs": 2,
                         "max_epochs": 1}}


def _images() -> np.ndarray:
    return np.random.RandomState(7).rand(2, IMG, IMG, 3).astype(np.float32)


@functools.cache
def _jax_side(q_type: str):
    """JAX-initialised variables (the EMA buffers moved off their initial
    values) and the JAX model's tokens and reconstructions of ``_images``."""
    model = JaxVQVAE.from_config(jax_parse_config(_raw(q_type)))
    variables = jax.tree.map(np.array, dict(model.init(
        model_rngs(3, q_type), jnp.zeros((1, IMG, IMG, 3)), train=False)))
    if "vq_state" in variables:
        rs = np.random.RandomState(11)
        q = variables["vq_state"]["quantizer"]
        q["ema_count"] = rs.rand(*q["ema_count"].shape).astype(np.float32) + 0.5
        q["ema_weight"] = rs.randn(*q["ema_weight"].shape).astype(np.float32)
    images = jnp.asarray(_images())
    if q_type == "gumbel":
        tokens = model.apply(variables, images, method="get_tokens", deterministic=True)
        recon = model.apply(variables, tokens, method="reconstruct_from_tokens")
    else:
        tokens = model.apply(variables, images, method="get_tokens")
        recon = model.apply(variables, images, method="reconstruct")
    return variables, np.asarray(tokens), np.asarray(recon)


def _params_file(tmp: Path, q_type: str) -> str:
    path = tmp / f"{q_type}.yaml"
    path.write_text(yaml.safe_dump(_raw(q_type)))
    return str(path)


def _lightning_state_dict(q_type: str) -> dict:
    """The port's VQVAE holding the JAX variables: its state_dict, which is
    the reference LightningModule's but for the loss stack."""
    variables, _, _ = _jax_side(q_type)
    cfg = parse_config(_raw(q_type))
    model = VQVAE.from_config(cfg, device="cpu")
    model.load_state_dict(convert_vqvae_variables(variables, NRB, LEVELS), strict=True)
    return {k: v.clone() for k, v in model.state_dict().items()}


def _assert_same_tree(got, want, path="") -> None:
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    else:
        assert got.shape == want.shape and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def _port_outputs(snapshot: str, q_type: str):
    """The snapshot under ``restore_for_eval``: (tokens, reconstructions,
    step), as the JAX side computes them."""
    cfg = parse_config(_raw(q_type))
    trainer = Trainer(cfg, learning_rate=1e-4, seed=0, steps_per_epoch=1, device="cpu")
    model_state = restore_for_eval(snapshot, trainer.init_state())
    model = model_state.model
    images = torch.from_numpy(_images())
    if q_type == "gumbel":
        tokens = model.get_tokens(images, deterministic=True)
        recon = model.reconstruct_from_tokens(tokens)
    else:
        tokens = model.get_tokens(images)
        recon = model.reconstruct(images)
    return tokens.numpy(), recon.numpy(), model_state.step


def _assert_jaxs_outputs(q_type: str, tokens, recon) -> None:
    _, want_tokens, want_recon = _jax_side(q_type)
    np.testing.assert_array_equal(tokens, want_tokens)
    np.testing.assert_allclose(recon, want_recon, rtol=RTOL, atol=ATOL)
    assert len(np.unique(want_tokens)) > 1


@pytest.mark.parametrize("q_type", Q_TYPES)
def test_port_state_dict_is_the_reference_layout(q_type):
    variables, _, _ = _jax_side(q_type)
    sd = {k: v.numpy() for k, v in _lightning_state_dict(q_type).items()}
    back = jax_convert(sd, q_type, num_res_blocks=NRB, num_levels=LEVELS)
    _assert_same_tree(back, variables)


@pytest.mark.parametrize("q_type", Q_TYPES)
def test_reference_ckpt_imports_to_jaxs_outputs(q_type, tmp_path):
    sd = _lightning_state_dict(q_type)
    sd["criterion.perceptual_loss.lin0.weight"] = torch.ones(1, 64, 1, 1)
    ckpt = tmp_path / "model.ckpt"
    torch.save({"epoch": 3, "global_step": 120, "state_dict": sd,
                "hyper_parameters": {"num_embeddings": 32}}, ckpt)
    params_file = _params_file(tmp_path, q_type)
    out = tmp_path / "imported"
    path = import_torch_checkpoint.main(["--ckpt", str(ckpt), "--params_file", params_file,
                                         "--output", str(out)])
    assert Path(path) == out / "state.pt"
    assert yaml.safe_load((out / "conf.yaml").read_text()) == _raw(q_type)
    tokens, recon, step = _port_outputs(str(out), q_type)
    _assert_jaxs_outputs(q_type, tokens, recon)
    assert step == 0


def _jax_training_snapshot(root: Path, q_type: str) -> Path:
    """A JAX ``CheckpointManager`` snapshot of a TrainState at step 11 with
    an optimizer state, as the JAX train CLI writes it."""
    variables, _, _ = _jax_side(q_type)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = create_train_state(params, optax.adamw(1e-4).init(params), 32, seed=0,
                               vq_state=jax.tree.map(jnp.asarray, variables.get("vq_state")))
    state = state.replace(step=jnp.asarray(11, jnp.int32))
    JaxCheckpointManager(str(root), "run").save(state, 2)
    return root / "run" / "epoch_0002"


@pytest.mark.parametrize("kind,q_type", [("eval", q) for q in Q_TYPES] + [("training", "ema")])
def test_jax_snapshot_imports_to_jaxs_outputs(kind, q_type, tmp_path):
    if kind == "eval":
        snapshot = tmp_path / "jax_eval"
        jax_save_eval_checkpoint(str(snapshot), _jax_side(q_type)[0], step=5)
        want_step = 5
    else:
        snapshot = _jax_training_snapshot(tmp_path, q_type)
        want_step = 11
    npz = tmp_path / "export" / "snapshot.npz"
    export = runpy.run_path(str(REPO / "tools" / "export_jax_checkpoint.py"))
    export["main"](["--loading_path", str(snapshot), "--output", str(npz)])
    with np.load(npz) as f:
        keys = set(f.files)
    assert "step" in keys and all(k.startswith(("params/", "vq_state/")) for k in keys - {"step"})
    assert any(k.startswith("vq_state/") for k in keys) == (q_type == "ema")
    params_file = _params_file(tmp_path, q_type)
    out = tmp_path / "imported"
    import_jax_checkpoint.main(["--npz", str(npz), "--params_file", params_file,
                                "--output", str(out)])
    tokens, recon, step = _port_outputs(str(out), q_type)
    _assert_jaxs_outputs(q_type, tokens, recon)
    assert step == want_step


def _faulty(sd: dict, fault: str):
    """``sd`` with one fault -> (state_dict, the key the error must name)."""
    sd = dict(sd)
    if fault == "missing":
        del sd["decoder.blocks.2.norm2.weight"]
        return sd, "decoder.blocks.2.norm2.weight"
    if fault == "extra":
        sd["encoder.blocks.1.conv1.weight"] = sd["encoder.blocks.0.conv1.weight"]
        return sd, "encoder.blocks.1.conv1.weight"
    sd["quantizer.codebook.weight"] = sd["quantizer.codebook.weight"][:, :4]
    return sd, "quantizer.codebook.weight"


@pytest.mark.parametrize("fault", ["missing", "extra", "misshapen"])
def test_a_wrong_key_raises_naming_it(fault, tmp_path):
    sd, key = _faulty(_lightning_state_dict("ema"), fault)
    ckpt = tmp_path / "model.ckpt"
    torch.save({"state_dict": sd}, ckpt)
    with pytest.raises((KeyError, ValueError), match=key.replace(".", r"\.")):
        import_torch_checkpoint.main(["--ckpt", str(ckpt), "--params_file",
                                      _params_file(tmp_path, "ema"), "--output",
                                      str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("fault", ["missing", "extra", "misshapen"])
def test_a_wrong_array_raises_naming_it(fault, tmp_path):
    variables, _, _ = _jax_side("gumbel")
    flat = {f"params/{k}": v for k, v in _flatten(variables["params"]).items()}
    flat["step"] = np.asarray(5)
    if fault == "missing":
        key = "params/decoder/up_0_block_0/norm1/scale"
        del flat[key]
    elif fault == "extra":
        key = "params/encoder/down_3_block_0/conv1/Conv_0/kernel"
        flat[key] = np.zeros((3, 3, 32, 32), np.float32)
    else:
        key = "quantizer.x_to_logits.weight"
        flat["params/quantizer/x_to_logits_kernel"] = np.zeros((1, 1, 32, 31), np.float32)
    npz = tmp_path / "bad.npz"
    np.savez(npz, **flat)
    with pytest.raises((KeyError, ValueError), match=key.replace(".", r"\.")):
        import_jax_checkpoint.main(["--npz", str(npz), "--params_file",
                                    _params_file(tmp_path, "gumbel"), "--output",
                                    str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("fault", [None, "filter", "missing"])
def test_reference_discriminator_state_dict(fault):
    """A reference D's state_dict (the port's names, plus the layers' fixed
    [1, 3, 3, 1] FIR buffers) -> the port's D, equal to the JAX D's weights
    the state_dict was made from; a FIR that is not the port's, or a
    missing weight, raises naming the key."""
    from vqvae_tpu.models import discriminator as jax_d
    from vqvae_tpu_torch.models.discriminator import Discriminator
    from vqvae_tpu_torch.ops.upfirdn2d import setup_filter
    from vqvae_tpu_torch.utils.convert import convert_discriminator_params
    from vqvae_tpu_torch.utils.torch_import import convert_discriminator_state_dict

    params = jax.device_get(jax_d.Discriminator(img_resolution=16, channel_base=256).init(
        jax.random.PRNGKey(2), jnp.zeros((4, 16, 16, 3)))["params"])
    want = convert_discriminator_params(params)
    sd = {k: v.clone() for k, v in want.items()}
    fir = torch.from_numpy(setup_filter([1, 3, 3, 1]))
    for key in ("b16.resample_filter", "b16.conv0.resample_filter", "b8.skip.resample_filter"):
        sd[key] = fir.clone()
    key = None
    if fault == "filter":
        key = "b8.skip.resample_filter"
        sd[key] = fir * 2
    elif fault == "missing":
        key = "b4.fc.weight"
        del sd[key]
    if key is not None:
        with pytest.raises((KeyError, ValueError), match=key.replace(".", r"\.")):
            convert_discriminator_state_dict(sd, 16, channel_base=256)
        return
    got = convert_discriminator_state_dict(sd, 16, channel_base=256)
    disc = Discriminator(16, channel_base=256, device="cpu")
    disc.load_state_dict(got, strict=True)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("params_file", sorted((REPO / "example_confs").glob("*.yaml")),
                         ids=lambda p: p.stem)
def test_import_template_is_the_model(params_file):
    """``vqvae_template`` has the keys and shapes of ``VQVAE.from_config``
    for every example config (both on the meta device: no weights drawn)."""
    cfg = load_config(str(params_file))
    with torch.device("meta"):
        want = VQVAE.from_config(cfg, device="meta").state_dict()
    got = vqvae_template(cfg).state_dict()
    assert [(k, tuple(v.shape)) for k, v in got.items()] == \
        [(k, tuple(v.shape)) for k, v in want.items()]


TAMING_RAW = {"image_size": 16,
              "autoencoder": {"layout": "taming", "channels": 32, "num_res_blocks": 1,
                              "channel_multipliers": [1, 2], "attn_resolutions": [8],
                              "z_channels": 16},
              "quantizer": {"type": "standard", "num_embeddings": 32, "embedding_dim": 8,
                            "reinit_every_n_epochs": None, "params": Q_PARAMS["standard"]}}


def test_taming_layout_state_dict_imports(tmp_path):
    """A tiny taming-layout model's ``state_dict`` (``nin_shortcut``,
    ``quant_conv``, ``mid.attn_1`` among its keys) through the import CLI:
    the snapshot holds every tensor unchanged and loads strictly."""
    cfg = parse_config(TAMING_RAW)
    sd = VQVAE.from_config(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(4)).state_dict()
    assert {"encoder.down.1.block.0.nin_shortcut.weight", "encoder.quant_conv.bias",
            "decoder.mid.attn_1.q.weight"} <= set(sd)
    torch.save(sd, tmp_path / "model.pt")
    params_file = tmp_path / "taming.yaml"
    params_file.write_text(yaml.safe_dump(TAMING_RAW))
    path = import_torch_checkpoint.main(["--ckpt", str(tmp_path / "model.pt"),
                                         "--params_file", str(params_file),
                                         "--output", str(tmp_path / "out")])
    got = torch.load(path, map_location="cpu")["model"]
    assert list(got) == list(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    VQVAE.from_config(cfg, device="cpu").load_state_dict(got, strict=True)
