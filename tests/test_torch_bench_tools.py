"""The port's input-pipeline bench and train-step decomposition on the CPU
(``bench_input.py``, ``bench_breakdown.py``, ``profile_tokenizer``'s ``step``
part), against ``tools/bench_input.py``, ``tools/bench_breakdown.py`` and
``tools/profile_step.py``:

- ``make_cfg`` parses to the JAX tool's config for each of the four
  variants;
- ``time_steps`` on a 16^2 GAN with R1 every 16 steps times host steps
  2-17: exactly one R1 step (host step 16) in its window, as a spy on
  ``steps.train_step``'s ``r1`` argument sees it, and reports which;
- the ``step`` part's window start puts exactly one R1 step in a window of
  ``CALLS`` calls after ``WARMUP`` (the JAX tool's window, host steps 3-6,
  holds none);
- ``bench_input.main`` at 16^2 counts every image on both loaders and
  returns positive rates;
- ``--remat``: ``bench_breakdown --remat 1 --device cpu`` and the ``step``
  part of ``profile_tokenizer`` with ``--remat 1`` run on the 16^2 config
  with every residual and D block checkpointed; the default stays ``0``.
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from vqvae_tpu_torch import bench_breakdown, bench_input, profile_tokenizer
from vqvae_tpu_torch.train import steps
from vqvae_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
BATCH = 4
MAKE_CFG = bench_breakdown.make_cfg   # the tests below patch the module's


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"{name}_tool", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("variant", sorted(bench_breakdown.VARIANTS))
def test_make_cfg_equals_the_jax_tools(variant):
    kw = bench_breakdown.VARIANTS[variant]
    want = _jax_tool("bench_breakdown").make_cfg(256, 128, **kw)
    got = bench_breakdown.make_cfg(256, 128, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.use_adversarial == kw["with_adv"]
    assert (got.use_adversarial and got.loss.adversarial.r1_reg_weight is not None) == kw["r1"]


def _tiny_cfg(image_size, channels, **variant):
    """``make_cfg`` cut to 16^2, channels 32, one residual block, N 32, D 8."""
    cfg = MAKE_CFG(16, 32, **variant)
    return dataclasses.replace(
        cfg, autoencoder=dataclasses.replace(cfg.autoencoder, num_res_blocks=1,
                                             channel_multipliers=(1, 2)),
        quantizer=dataclasses.replace(cfg.quantizer, num_embeddings=32, embedding_dim=8))


@pytest.fixture(scope="module")
def gan_r1(tmp_path_factory):
    """``make_cfg``'s ``gan_r1`` cut to 16^2, channels 32, one residual block
    (R1 every 16 steps kept), its Trainer (a narrow D), state and batch."""
    cfg = _tiny_cfg(256, 128, **bench_breakdown.VARIANTS["gan_r1"])
    assert cfg.loss.adversarial.r1_reg_every == 16
    mp = pytest.MonkeyPatch()
    mp.setenv("VQVAE_TPU_LPIPS_WEIGHTS_DIR", str(tmp_path_factory.mktemp("lpips")))
    with pytest.warns(UserWarning, match="LPIPS"):
        trainer = Trainer(cfg, learning_rate=1e-4, seed=0, steps_per_epoch=1000,
                          device="cpu", disc_kwargs={"channel_base": 256})
    mp.undo()
    state = trainer.init_state()
    images = torch.randint(0, 256, (BATCH, 16, 16, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    return trainer, state, {"image": images}


class _R1Spy:
    """Records the ``r1`` argument of every ``steps.train_step`` call."""

    def __init__(self, monkeypatch):
        self.r1 = []
        real = steps.train_step

        def train_step(*args, **kwargs):
            self.r1.append(kwargs["r1"])
            return real(*args, **kwargs)

        monkeypatch.setattr(steps, "train_step", train_step)


def test_time_steps_window_holds_one_r1_step(gan_r1, monkeypatch):
    trainer, state, batch = gan_r1
    trainer.host_step = 0   # a fresh Trainer's
    spy = _R1Spy(monkeypatch)
    t = bench_breakdown.time_steps(trainer, state, batch)
    warmup, n = bench_breakdown.WARMUP, bench_breakdown.STEPS
    assert (warmup, n) == (2, 16)
    assert len(spy.r1) == warmup + n
    assert spy.r1[:warmup] == [True, False]   # host step 0 is R1, as in JAX
    window = spy.r1[warmup:]
    assert sum(window) == 1 and window.index(True) == 16 - warmup   # host step 16
    assert t["r1"] == window
    assert len(t["step_ms"]) == n and all(ms > 0 for ms in t["step_ms"])
    assert t["metrics"][window.index(True)]["r1_penalty"] > 0
    assert all(m["r1_penalty"] == 0 for m, r in zip(t["metrics"], window) if not r)


def test_profile_step_window_holds_one_r1_step(gan_r1, monkeypatch):
    trainer, state, batch = gan_r1
    warmup, calls = profile_tokenizer.WARMUP, profile_tokenizer.CALLS
    trainer.host_step = profile_tokenizer.step_window_start(16)
    spy = _R1Spy(monkeypatch)
    for _ in range(warmup + calls):
        trainer.train_step(state, batch, epoch=0)
    assert sum(spy.r1[:warmup]) == 0
    assert spy.r1[warmup:] == [True] + [False] * (calls - 1)
    # the JAX tool's window: 3 warm-up steps from host step 0, then 4
    trainer.host_step = 0
    spy.r1.clear()
    for _ in range(7):
        trainer.train_step(state, batch, epoch=0)
    assert sum(spy.r1[3:]) == 0


def test_bench_input_counts_every_image(tmp_path, capsys):
    found = bench_input.main(["--image_size", "16", "--n", "64", "--workers", "2",
                              "--tmp", str(tmp_path)])
    assert found["packed_images"] == found["folder_images"] == 64   # n <= 512: one each
    assert found["packed"] > 0 and found["folder"] > 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"packed reader  (native={found['native']}):")
    assert out[1].startswith("image folder (PIL jpeg decode + resize):")
    assert len(list((tmp_path / "imgs16").glob("*.jpg"))) == 64
    assert (tmp_path / "data16_64.pack").is_file()


class _TrainerSpy:
    """Replaces ``loop.Trainer`` by a subclass that keeps each instance."""

    def __init__(self, monkeypatch):
        from vqvae_tpu_torch.train import loop
        self.made = []
        spy = self

        class Spied(loop.Trainer):
            def __post_init__(self):
                super().__post_init__()
                spy.made.append(self)

            def init_state(self):
                state = super().init_state()
                spy.states.append(state)
                return state

        self.states = []
        monkeypatch.setattr(loop, "Trainer", Spied)


def _all_checkpointed(state) -> bool:
    from vqvae_tpu_torch.models.autoencoder import ResBlock
    blocks = [m for m in state.model.modules() if isinstance(m, ResBlock)]
    return bool(blocks) and all(m.remat for m in blocks)


def test_bench_breakdown_remat_flag(monkeypatch):
    assert bench_breakdown.parse_args([]).remat == "0"
    assert [bench_breakdown.remat_arg(v) for v in ("0", "1", "auto")] == [False, True, None]
    monkeypatch.setattr(bench_breakdown, "make_cfg", _tiny_cfg)
    real = bench_breakdown.time_steps
    monkeypatch.setattr(bench_breakdown, "time_steps",
                        lambda trainer, state, batch: real(trainer, state, batch, n=2))
    spy = _TrainerSpy(monkeypatch)
    rec = bench_breakdown.main(["--remat", "1", "--device", "cpu", "--configs", "mse",
                                "--batch", str(BATCH)])
    assert rec["remat"] == "1" and rec["mse"]["finite"] and len(rec["mse"]["step_ms"]) == 2
    assert [t.remat for t in spy.made] == [True] and _all_checkpointed(spy.states[0])


def test_profile_step_remat_flag(monkeypatch):
    args = profile_tokenizer.parse_args(["step", "mse", "--remat", "1"])
    assert (args.part, args.variant, args.remat) == ("step", "mse", "1")
    assert profile_tokenizer.parse_args([]).remat == "0"
    monkeypatch.setattr(bench_breakdown, "make_cfg", _tiny_cfg)
    monkeypatch.setattr(profile_tokenizer, "BATCH", BATCH)
    calls = []

    def profile_call(fn):   # the CPU has no CUDA events or device trace
        for _ in range(profile_tokenizer.WARMUP + profile_tokenizer.CALLS):
            calls.append(fn())
        return 1.0, 1.0, {}

    monkeypatch.setattr(profile_tokenizer, "profile_call", profile_call)
    spy = _TrainerSpy(monkeypatch)
    window = profile_tokenizer.profile_step(args.variant, torch.device("cpu"), "cpu",
                                            bench_breakdown.remat_arg(args.remat))
    assert window == [False] * profile_tokenizer.CALLS
    assert len(calls) == profile_tokenizer.WARMUP + profile_tokenizer.CALLS
    assert [t.remat for t in spy.made] == [True] and _all_checkpointed(spy.states[0])
