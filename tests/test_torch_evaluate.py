"""The port's eval entry point on the CPU, against ``evaluate.py``:

- ``evaluate_checkpoint`` on a tiny standard config, the port's weights
  converted from the JAX Trainer's state, two batches of 4 uint8 images, the
  second with 2 masked rows of garbage, seeded FID-inception weights
  (``random_inception_npz``) read by both sides: mse / psnr / ssim rtol 1e-5,
  ``used_codebook`` and ``perplexity`` exactly, rFID rtol ``RFID_RTOL``. The
  covariances of 6 samples in 2048 dimensions are rank 5, so rFID is the
  quantity most sensitive to rounding; the measured gap was 5.5e-8
  relative (36.4833842 against 36.4833862, CPU, torch 2.13);
- the CLI without the weights and without ``--allow_missing_rfid`` exits
  non-zero naming the converter, before it looks at the dataset;
- ``restore_for_eval`` loads a snapshot written by the port's GAN
  ``run_training`` into a ``loss=None`` Trainer (the model's weights and
  ``step``; the D and the optimizers are ignored);
- both CLIs (``cli.evaluate`` and ``cli.tokenize_dataset``) end to end with
  ``--device cpu`` on a tiny packed test split.
"""

import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vqvae_tpu.config import parse_config as jax_parse_config
from vqvae_tpu.train.loop import Trainer as JaxTrainer
from vqvae_tpu_torch.cli import evaluate as cli_evaluate
from vqvae_tpu_torch.cli import tokenize_dataset as cli_tokenize
from vqvae_tpu_torch.config import parse_config
from vqvae_tpu_torch.data.packed import write_packed
from vqvae_tpu_torch.train import loop
from vqvae_tpu_torch.train.loop import Trainer
from vqvae_tpu_torch.utils.checkpoint import restore_for_eval
from vqvae_tpu_torch.utils.convert import convert_vqvae_variables, random_inception_npz

torch.set_num_threads(2)

RFID_RTOL = 1e-3
IMG = 16
RAW = {
    "image_size": IMG,
    "autoencoder": {"channels": 32, "num_res_blocks": 1, "channel_multipliers": [1, 2]},
    "quantizer": {"num_embeddings": 32, "embedding_dim": 8, "type": "standard",
                  "reinit_every_n_epochs": None, "params": {"commitment_cost": 0.25}},
    "training": {"cumulative_bs": 4, "base_lr": 1e-4, "betas": [0.0, 0.99], "eps": 1e-8,
                 "weight_decay": 1e-4, "decay_epochs": 2, "max_epochs": 1},
}


@pytest.fixture(scope="module")
def inception_npz(tmp_path_factory):
    return random_inception_npz(tmp_path_factory.mktemp("fid") / "inception_fid.npz", seed=7)


def _batches():
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (8, IMG, IMG, 3)).astype(np.uint8)
    return [{"image": imgs[:4], "mask": np.ones(4, bool)},
            {"image": imgs[4:], "mask": np.array([True, True, False, False])}]


def test_evaluate_checkpoint_matches_jax(inception_npz, monkeypatch):
    from evaluate import evaluate_checkpoint as jax_evaluate_checkpoint
    monkeypatch.setenv("VQVAE_TPU_INCEPTION_WEIGHTS", inception_npz)
    jt = JaxTrainer(cfg=jax_parse_config(RAW), learning_rate=1e-4, seed=0, steps_per_epoch=1,
                    mesh=None, compute_dtype=jnp.float32)
    try:
        jstate = jt.init_state()
        want = jax_evaluate_checkpoint(jt.cfg, jstate, jt, _batches(), verbose=False)
    finally:
        jt.native_lr.destroy()
    variables = jax.tree.map(np.array, {"params": jstate.params})
    cfg = parse_config(RAW)
    trainer = Trainer(cfg, learning_rate=1e-4, seed=0, steps_per_epoch=1, device="cpu")
    state = trainer.init_state()
    state.model.load_state_dict(convert_vqvae_variables(variables, 1, 2), strict=True)
    got = cli_evaluate.evaluate_checkpoint(cfg, state, trainer, _batches(), verbose=False)

    assert set(got) == set(want) == {"mse", "psnr", "ssim", "used_codebook", "perplexity",
                                     "rfid"}
    for k in ("mse", "psnr", "ssim"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert got["used_codebook"] == float(want["used_codebook"])
    assert got["perplexity"] == float(want["perplexity"])
    np.testing.assert_allclose(got["rfid"], want["rfid"], rtol=RFID_RTOL)
    assert got["rfid"] > 0


def test_uint8_conversion_truncates_equal_bins():
    x = torch.tensor([0.0, 1 / 256, 0.5, 0.999, 1.0, -0.1, 1.5])
    got = cli_evaluate.to_uint8(x)
    want = np.clip(x.numpy() * (256.0 - 1e-3), 0, 255).astype(np.uint8)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [0, 0, 127, 255, 255, 0, 255]


def test_cli_without_weights_exits_naming_the_converter(monkeypatch, tmp_path):
    monkeypatch.setenv("VQVAE_TPU_INCEPTION_WEIGHTS", str(tmp_path / "missing.npz"))
    with pytest.raises(SystemExit) as exc:
        cli_evaluate.main(["--params_file", str(tmp_path / "no.yaml"), "--dataset_path",
                           str(tmp_path / "no_data"), "--batch_size", "4", "--seed", "0",
                           "--loading_path", str(tmp_path / "no_ckpt")])
    assert exc.value.code not in (0, None)
    assert "tools/convert_inception_weights.py" in str(exc.value.code)
    assert "--allow_missing_rfid" in str(exc.value.code)


def _gan_raw():
    return {**RAW, "loss": {"l1_weight": 1.0, "l2_weight": 1.0, "perc_weight": 0.0,
                            "adversarial_params": {"start_epoch": 0, "loss_type": "non-saturating",
                                                   "g_weight": 0.1, "use_adaptive": False,
                                                   "r1_reg_weight": None}}}


class _Loader:
    """A finite loader of fixed batches with ``set_epoch`` and ``batch_size``."""

    def __init__(self, batches):
        self.batches, self.batch_size = batches, batches[0]["image"].shape[0]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)

    def set_epoch(self, epoch):
        pass


@pytest.fixture(scope="module")
def gan_run(tmp_path_factory):
    """One epoch of 2 steps of a tiny GAN config through ``run_training``
    (a narrow D): -> (config path, run directory, final state)."""
    from vqvae_tpu_torch.models.discriminator import Discriminator
    tmp = tmp_path_factory.mktemp("gan")
    params = tmp / "gan.yaml"
    params.write_text(yaml.safe_dump(_gan_raw()))
    rs = np.random.RandomState(3)
    train = _Loader([{"image": rs.randint(0, 256, (4, IMG, IMG, 3)).astype(np.uint8)}
                     for _ in range(2)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "Discriminator", functools.partial(Discriminator, channel_base=256))
        state, _ = loop.run_training(parse_config(_gan_raw()), train, None, seed=0,
                                     learning_rate=1e-3, save_dir=str(tmp), run_name="gan",
                                     device="cpu", check_val_every=10)
    return params, tmp / "gan", state


def test_restore_for_eval_loads_a_gan_snapshot(gan_run):
    params, run, trained = gan_run
    assert trained.disc is not None and trained.step == 2
    cfg = dataclasses.replace(parse_config(_gan_raw()), loss=None)
    trainer = Trainer(cfg, learning_rate=1e-4, seed=5, steps_per_epoch=1, device="cpu")
    fresh = trainer.init_state()
    assert fresh.disc is None
    payload = torch.load(run / "last" / "state.pt", weights_only=True)
    assert {"disc", "disc_optimizer"} <= set(payload)
    state = restore_for_eval(str(run / "last"), fresh)
    assert state.step == 2 and state.disc is None
    for k, v in trained.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
    assert state.model.quantizer.codebook.weight.device.type == "cpu"
    assert int(state.usage_count.sum()) == 0 and state.optimizer.state_dict()["state"] == {}


def test_both_clis_end_to_end_on_cpu(gan_run, inception_npz, monkeypatch, tmp_path):
    params, run, _ = gan_run
    data = tmp_path / "data"
    data.mkdir()
    rs = np.random.RandomState(4)
    write_packed(str(data / "test.pack"),
                 (rs.randint(0, 256, (IMG, IMG, 3)).astype(np.uint8) for _ in range(6)), IMG)
    monkeypatch.setenv("VQVAE_TPU_INCEPTION_WEIGHTS", inception_npz)
    results = cli_evaluate.main(["--params_file", str(params), "--dataloader", "packed",
                                 "--dataset_path", str(data), "--batch_size", "4", "--seed", "0",
                                 "--loading_path", str(run / "last"), "--device", "cpu"])
    assert set(results) == {"mse", "psnr", "ssim", "used_codebook", "perplexity", "rfid"}
    assert all(math.isfinite(v) for v in results.values())
    assert 0 < results["used_codebook"] <= 100 and results["perplexity"] >= 1

    out = tmp_path / "tokens"
    manifest = cli_tokenize.main(["--params_file", str(params), "--loading_path",
                                  str(run / "last"), "--dataset_path", str(data),
                                  "--output_folder", str(out), "--splits", "test",
                                  "--batch_size", "4", "--dataloader", "packed",
                                  "--workers", "1", "--device", "cpu"])
    tokens = np.load(out / "test_tokens.npy")
    assert tokens.dtype == np.int32 and tokens.shape == (6, 16)
    assert ((tokens >= 0) & (tokens < 32)).all()
    assert json.loads((out / "manifest.json").read_text()) == manifest
    assert manifest["splits"]["test"] == {"file": "test_tokens.npy", "num_sequences": 6,
                                          "seq_len": 16}
