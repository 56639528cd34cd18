"""The port's token-export CLI (``vqvae_tpu_torch.cli.tokenize_dataset``)
against the JAX package's ``tools/tokenize_dataset.py`` on the CPU: the same
weights (a JAX orbax snapshot on one side, the port's ``state.pt`` of the
converted variables on the other) and the same packed splits (6 and 5
images at batch 4, so both last batches are padded). The token ``.npy``
files are exactly equal and the manifests equal, for a standard config and
for a gumbel one with deterministic tokens; ``--sampled_tokens`` draws from
a seeded generator (the same tokens for the same seed) and ``--spatial``
under a group of one process writes the plain run's tokens.
"""

import json
import runpy
import socket
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vqvae_tpu.config import parse_config as jax_parse_config
from vqvae_tpu.models.vqvae import VQVAE as JaxVQVAE
from vqvae_tpu.utils.checkpoint import save_eval_checkpoint
from vqvae_tpu_torch.cli import tokenize_dataset as cli_tokenize
from vqvae_tpu_torch.config import parse_config
from vqvae_tpu_torch.data.packed import write_packed
from vqvae_tpu_torch.parallel import spatial
from vqvae_tpu_torch.train.loop import Trainer
from vqvae_tpu_torch.utils.checkpoint import CheckpointManager
from vqvae_tpu_torch.utils.convert import convert_vqvae_variables

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
IMG = 16
QUANTIZERS = {
    "standard": {"commitment_cost": 0.25},
    "gumbel": {"straight_through": False, "temp": 1.0, "kl_cost": 5e-4},
}


def _raw(q_type):
    return {"image_size": IMG,
            "autoencoder": {"channels": 32, "num_res_blocks": 1, "channel_multipliers": [1, 2]},
            "quantizer": {"type": q_type, "num_embeddings": 32, "embedding_dim": 8,
                          "reinit_every_n_epochs": None, "params": QUANTIZERS[q_type]},
            "training": {"cumulative_bs": 4, "base_lr": 1e-4, "betas": [0.0, 0.99],
                         "eps": 1e-8, "weight_decay": 1e-4, "decay_epochs": 2,
                         "max_epochs": 1}}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("tok_data")
    rs = np.random.RandomState(5)
    for split, n in (("train", 6), ("validation", 5)):
        write_packed(str(root / f"{split}.pack"),
                     (rs.randint(0, 256, (IMG, IMG, 3)).astype(np.uint8) for _ in range(n)), IMG)
    return root


def _checkpoints(root: Path, q_type: str):
    """(params file, JAX snapshot, port snapshot) of one set of weights."""
    raw = _raw(q_type)
    params = root / f"{q_type}.yaml"
    params.write_text(yaml.safe_dump(raw))
    jmodel = JaxVQVAE.from_config(jax_parse_config(raw))
    variables = jax.tree.map(np.array, dict(jmodel.init(jax.random.PRNGKey(3),
                                                        jnp.zeros((1, IMG, IMG, 3)))))
    save_eval_checkpoint(str(root / "jax_ckpt"), variables, step=7)
    trainer = Trainer(parse_config(raw), learning_rate=1e-4, seed=0, steps_per_epoch=1,
                      device="cpu")
    state = trainer.init_state()
    state.model.load_state_dict(convert_vqvae_variables(variables, 1, 2), strict=True)
    state.step = 7
    CheckpointManager(str(root), "port").save(state, 0)
    return params, root / "jax_ckpt", root / "port" / "last"


def _run_jax_cli(argv, monkeypatch):
    module = runpy.run_path(str(REPO / "tools" / "tokenize_dataset.py"))
    monkeypatch.setattr(sys, "argv", ["tokenize_dataset.py", *argv])
    module["main"]()


@pytest.mark.parametrize("q_type", ["standard", "gumbel"])
def test_tokens_equal_the_jax_clis(q_type, data, tmp_path, monkeypatch):
    params, jax_ckpt, port_ckpt = _checkpoints(tmp_path, q_type)
    common = ["--params_file", str(params), "--dataset_path", str(data), "--splits", "train",
              "validation", "--batch_size", "4", "--dataloader", "packed", "--workers", "1",
              "--seed", "3"]
    _run_jax_cli([*common, "--loading_path", str(jax_ckpt), "--output_folder",
                  str(tmp_path / "jax")], monkeypatch)
    manifest = cli_tokenize.main([*common, "--loading_path", str(port_ckpt), "--output_folder",
                                  str(tmp_path / "port"), "--device", "cpu"])
    want = json.loads((tmp_path / "jax" / "manifest.json").read_text())
    assert json.loads((tmp_path / "port" / "manifest.json").read_text()) == manifest == want
    assert want["quantizer"] == q_type and want["latent_tokens"] == 16
    for split, n in (("train", 6), ("validation", 5)):
        got = np.load(tmp_path / "port" / f"{split}_tokens.npy")
        ref = np.load(tmp_path / "jax" / f"{split}_tokens.npy")
        assert got.dtype == ref.dtype == np.int32 and got.shape == ref.shape == (n, 16)
        np.testing.assert_array_equal(got, ref)
    assert len(np.unique(ref)) > 4


def test_sampled_tokens_follow_the_seed(data, tmp_path):
    params, _, port_ckpt = _checkpoints(tmp_path, "gumbel")
    runs = {}
    for name, seed in (("a", "1"), ("b", "1"), ("c", "2"), ("argmax", "1")):
        extra = [] if name == "argmax" else ["--sampled_tokens"]
        cli_tokenize.main(["--params_file", str(params), "--loading_path", str(port_ckpt),
                           "--dataset_path", str(data), "--splits", "train", "--batch_size",
                           "4", "--dataloader", "packed", "--workers", "1", "--seed", seed,
                           "--output_folder", str(tmp_path / name), "--device", "cpu", *extra])
        runs[name] = np.load(tmp_path / name / "train_tokens.npy")
    np.testing.assert_array_equal(runs["a"], runs["b"])
    assert not np.array_equal(runs["a"], runs["c"])
    assert not np.array_equal(runs["a"], runs["argmax"])


def test_spatial_names_its_roadmap_item(data, tmp_path, monkeypatch):
    """``--spatial`` is ported: under torchrun's environment at world 1 (gloo
    with ``--device cpu``) it writes the tokens of the run without it and
    leaves the group it started; with ``--sampled_tokens`` it raises (the
    two ranks' case is ``tests/test_torch_spatial.py``)."""
    params, _, port_ckpt = _checkpoints(tmp_path, "gumbel")
    common = ["--params_file", str(params), "--loading_path", str(port_ckpt), "--dataset_path",
              str(data), "--splits", "train", "--batch_size", "4", "--dataloader", "packed",
              "--workers", "1", "--seed", "3", "--device", "cpu"]
    with pytest.raises(ValueError, match="deterministic tokens only"):
        cli_tokenize.main([*common, "--output_folder", str(tmp_path / "x"), "--spatial",
                           "--sampled_tokens"])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for name, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                        ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port))):
        monkeypatch.setenv(name, value)
    seen = []
    real = spatial.make_spatial_apply

    def record(*args, **kwargs):
        seen.append((torch.distributed.get_backend(), torch.distributed.get_world_size()))
        return real(*args, **kwargs)

    monkeypatch.setattr(spatial, "make_spatial_apply", record)
    cli_tokenize.main([*common, "--output_folder", str(tmp_path / "spatial"), "--spatial"])
    assert seen == [("gloo", 1)] and not torch.distributed.is_initialized()
    cli_tokenize.main([*common, "--output_folder", str(tmp_path / "plain")])
    np.testing.assert_array_equal(np.load(tmp_path / "spatial" / "train_tokens.npy"),
                                  np.load(tmp_path / "plain" / "train_tokens.npy"))
