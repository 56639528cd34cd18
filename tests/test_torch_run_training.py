"""The port's training entry point on the CPU: ``cli.train.main([...,
'--device', 'cpu'])`` against the JAX package's ``run_training`` on one tiny
config, bit-exact resume, and the guards.

- Two epochs of a tiny standard-VQ config (16^2 PNG folder, 16 train and 10
  validation images, batch 4, reinit every epoch) through the port's CLI and
  through JAX's ``run_training`` (its loaders, logger and checkpoints, no
  mesh) leave the same run directory: the same ``metrics.jsonl`` records
  (keys and ``step`` of each line, in order), the same checkpoint
  directories and the same panel files.
- Resume: an EMA config with ``grad_accum_steps 2`` and reinit every epoch,
  trained 2 epochs straight, equals (``torch.equal``) 1 epoch, a resume from
  ``last/`` and 1 more: every parameter, optimizer moment, EMA buffer, the
  usage counts, the step counters and both generators' states, and the
  resumed run's metrics continue the first run's steps.
- Guards: a missing dataset path raises ``FileNotFoundError``; a GAN
  micro-batch not divisible by 4 and a batch not divisible by the
  accumulation count raise ``RuntimeError``; ``--device cuda`` without a card
  raises.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from vqvae_tpu_torch.cli import train as cli_train

torch.set_num_threads(1)

IMG = 16


def _config(q_type="standard", accum=1, batch=4, loss=None) -> dict:
    params = {"commitment_cost": 0.25}
    if q_type == "ema":
        params.update(decay=0.95, epsilon=1e-5)
    raw = {
        "image_size": IMG,
        "autoencoder": {"channels": 32, "num_res_blocks": 1, "channel_multipliers": [1, 2]},
        "quantizer": {"type": q_type, "num_embeddings": 32, "embedding_dim": 8,
                      "reinit_every_n_epochs": 1, "params": params},
        "training": {"cumulative_bs": batch, "grad_accum_steps": accum, "base_lr": 1e-3,
                     "betas": [0.0, 0.99], "eps": 1e-8, "weight_decay": 1e-4,
                     "decay_epochs": 2, "max_epochs": 2},
    }
    if loss:
        raw["loss"] = loss
    return raw


def _write(tmp_path, name, raw) -> str:
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    Image = pytest.importorskip("PIL.Image")
    root = tmp_path_factory.mktemp("data")
    rs = np.random.RandomState(0)
    for split, n in (("train", 16), ("validation", 10)):
        (root / split).mkdir()
        for i in range(n):
            Image.fromarray(rs.randint(0, 256, (IMG, IMG, 3)).astype(np.uint8)).save(
                root / split / f"i{i:02d}.png")
    return str(root)


def _train(params_file, data, save, run, *extra):
    return cli_train.main(["--params_file", params_file, "--dataset_path", data,
                           "--save_path", str(save), "--run_name", run, "--seed", "0",
                           "--device", "cpu", "--precision", "fp32", *extra])


def _records(run_dir: Path):
    lines = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    return [(sorted(r), r["step"]) for r in lines]


def _listing(run_dir: Path):
    return sorted(p.name for p in run_dir.iterdir())


def test_cli_run_matches_jax_run_training(tmp_path, image_folder):
    import jax.numpy as jnp

    from vqvae_tpu.config import parse_config as jax_parse_config
    from vqvae_tpu.data.dataset import get_loaders as jax_get_loaders
    from vqvae_tpu.train.loop import run_training as jax_run_training
    from vqvae_tpu.utils.logging import MetricLogger as JaxLogger

    raw = _config()
    state, trainer = _train(_write(tmp_path, "tiny", raw), image_folder, tmp_path / "port",
                            "r", "--max_epochs", "2")
    assert state.step == 8 and not trainer.native_lr.is_native   # destroyed at the end

    cfg = jax_parse_config(raw)
    train, val = jax_get_loaders("standard", image_folder, IMG, 4, 1, 0, shard_rank=0,
                                 shard_count=1)
    logger = JaxLogger(str(tmp_path / "jax"), "r")
    jax_run_training(cfg, train, val, seed=0, learning_rate=cfg.training.scaled_lr(),
                     save_dir=str(tmp_path / "jax"), run_name="r", logger=logger,
                     compute_dtype=jnp.float32, max_epochs=2)
    logger.finish()

    port_dir, jax_dir = tmp_path / "port" / "r", tmp_path / "jax" / "r"
    assert _records(port_dir) == _records(jax_dir)
    assert _listing(port_dir) == _listing(jax_dir) == [
        "epoch_0000", "epoch_0001", "last", "metrics.jsonl", "train_reconstructions_3.png",
        "validation_reconstructions_4.png"]
    last = [json.loads(x) for x in (port_dir / "metrics.jsonl").read_text().splitlines()][-1]
    assert all(np.isfinite(v) for v in last.values())


def _snapshot(path: Path) -> dict:
    return torch.load(path / "state.pt", map_location="cpu", weights_only=True)


def _assert_equal(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_resume_is_bit_exact(tmp_path, image_folder):
    params_file = _write(tmp_path, "ema", _config("ema", accum=2))
    _train(params_file, image_folder, tmp_path, "straight", "--max_epochs", "2")
    _train(params_file, image_folder, tmp_path, "resumed", "--max_epochs", "1")
    state, _ = _train(params_file, image_folder, tmp_path, "resumed", "--max_epochs", "2",
                      "--loading_path", str(tmp_path / "resumed" / "last"))
    assert state.step == 8
    want, got = _snapshot(tmp_path / "straight" / "last"), _snapshot(tmp_path / "resumed" / "last")
    assert {"model", "optimizer", "usage_count", "generator", "step", "disc_step",
            "epoch"} <= set(got)
    assert got["epoch"] == 1 and got["optimizer"]["state"]   # moments were saved
    assert {"ema_count", "ema_weight"} <= {k.split(".")[-1] for k in got["model"]}
    _assert_equal(got, want)
    steps = [json.loads(x)["step"] for x in
             (tmp_path / "resumed" / "metrics.jsonl").read_text().splitlines()]
    assert steps[0] == 4 and steps[-1] == 8 and steps == sorted(steps)


def test_guards(tmp_path, image_folder):
    tiny = _write(tmp_path, "tiny", _config())
    with pytest.raises(FileNotFoundError):
        _train(tiny, "/nope/", tmp_path, "g")
    gan_loss = {"l1_weight": 1.0, "l2_weight": 1.0, "perc_weight": 0.0,
                "adversarial_params": {"start_epoch": 0, "loss_type": "non-saturating",
                                       "g_weight": 0.1, "use_adaptive": False,
                                       "r1_reg_weight": 10.0, "r1_reg_every": 16}}
    gan = _write(tmp_path, "gan", _config(batch=6, loss=gan_loss))
    with pytest.raises(RuntimeError, match="divisible by 4"):
        _train(gan, image_folder, tmp_path, "g")
    gan_accum = _write(tmp_path, "gan_accum", _config(batch=8, accum=4, loss=gan_loss))
    with pytest.raises(RuntimeError, match="divisible by 4"):   # micro-batch 2
        _train(gan_accum, image_folder, tmp_path, "g")
    accum = _write(tmp_path, "accum", _config(batch=6, accum=4))
    with pytest.raises(RuntimeError, match="grad_accum_steps=4"):
        _train(accum, image_folder, tmp_path, "g")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_train.main(["--params_file", tiny, "--dataset_path", image_folder,
                            "--save_path", str(tmp_path), "--run_name", "g", "--seed", "0"])
