"""The port's headline benchmark (``vqvae_tpu_torch/bench.py``) on the CPU,
against the repo-root ``bench.py``:

- the flagship dict and sizing equal ``_flagship_raw``'s on the card and on
  the CPU (under the bench's env knobs too), and the secondary legs'
  configs and ``Trainer`` arguments equal those ``_bench_plain`` /
  ``_bench_gan_plain`` / ``_bench_flagship`` build (captured by a recorder
  in place of each package's ``Trainer``);
- with the default warm-up and windows, each timed window holds exactly
  one R1 step, on a tiny GAN ``Trainer``, as ``r1_due`` and the step
  itself see it;
- the orchestrator's stdout contract, the leg processes stubbed: the
  flagship line first, the enriched line last, a failed secondary leg as an
  ``error:`` string, a late crash re-emitting the flagship record, a
  flagship failure as one line and a non-zero exit;
- one run of ``python -m vqvae_tpu_torch.bench --device cpu`` end to end.
"""

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from vqvae_tpu_torch import bench
from vqvae_tpu_torch.config import parse_config
from vqvae_tpu_torch.train import loop, steps
from vqvae_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
ENVS = [{}, {"VQGAN_BENCH_ACCUM": "2"}, {"VQGAN_BENCH_BATCH": "16", "VQGAN_BENCH_ACCUM": "1"}]


@pytest.fixture
def env(monkeypatch):
    """A clean bench environment; -> a setter of variables."""
    for name in list(os.environ):
        if name.startswith("VQGAN_") or name.startswith("VQVAE_TPU_FUSED"):
            monkeypatch.delenv(name)
    return lambda **kw: [monkeypatch.setenv(k, v) for k, v in kw.items()]


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location("jax_root_bench", ROOT / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Backend:
    def __init__(self, name):
        self.name = name

    def default_backend(self):
        return self.name


class _Built(Exception):
    pass


def _recorder(seen: list):
    """A stand-in ``Trainer`` that records its arguments and stops the leg."""
    def trainer(*args, **kwargs):
        seen.append({"cfg": args[0] if args else kwargs.pop("cfg"), **kwargs})
        raise _Built
    return trainer


def _jax_trainer_args(monkeypatch, fn, *args) -> dict:
    import vqvae_tpu.train.loop as jax_loop
    seen = []
    monkeypatch.setattr(jax_loop, "Trainer", _recorder(seen))
    with pytest.raises(_Built):
        fn(*args)
    return seen[0]


def _port_trainer_args(monkeypatch, fn, *args) -> dict:
    seen = []
    monkeypatch.setattr(loop, "Trainer", _recorder(seen))
    with pytest.raises(_Built):
        fn(*args, device="cpu")
    return seen[0]


@pytest.mark.parametrize("on_card", [True, False], ids=["card", "cpu"])
@pytest.mark.parametrize("variables", ENVS, ids=["default", "accum2", "batch16"])
def test_flagship_raw_equals_the_jax_benchs(jax_bench, env, on_card, variables):
    env(**variables)
    raw, size, batch, accum, on_tpu = jax_bench._flagship_raw(
        _Backend("tpu" if on_card else "cpu"))
    assert on_tpu == on_card
    assert bench.flagship_raw(on_card) == (raw, size, batch, accum)
    assert dataclasses.asdict(parse_config(bench.flagship_raw(on_card)[0])) == \
        dataclasses.asdict(parse_config(raw))


@pytest.mark.parametrize("on_card", [True, False], ids=["card", "cpu"])
@pytest.mark.parametrize("leg", ["gan_b32_plain", "standard_vqvae", "ema_vqvae", "entropy_vqvae"])
def test_secondary_configs_equal_the_jax_benchs(jax_bench, env, monkeypatch, on_card, leg):
    """The card's configs (the port's dict functions) and the CPU's (the
    ``Trainer`` the port's leg builds) against the JAX legs' ``Trainer``."""
    raw, size = jax_bench._flagship_raw(_Backend("tpu" if on_card else "cpu"))[:2]
    if leg == "gan_b32_plain":
        want = _jax_trainer_args(monkeypatch, jax_bench._bench_gan_plain, raw, size, jnp)
        ours = bench.gan_plain_raw(bench.flagship_raw(on_card)[0])
        leg_fn = (bench.bench_gan_plain,)
    else:
        q_type = bench.PLAIN_LEGS[leg]
        want = _jax_trainer_args(monkeypatch, jax_bench._bench_plain, raw, q_type, size, jnp)
        ours = bench.plain_raw(bench.flagship_raw(on_card)[0], q_type)
        leg_fn = (bench.bench_plain, q_type)
    assert dataclasses.asdict(parse_config(ours)) == dataclasses.asdict(want["cfg"])
    assert ("loss" in ours) == (leg == "gan_b32_plain")
    if on_card:
        return
    got = _port_trainer_args(monkeypatch, *leg_fn)
    assert dataclasses.asdict(got["cfg"]) == dataclasses.asdict(want["cfg"])
    for key in ("learning_rate", "seed", "steps_per_epoch", "remat"):
        assert got[key] == want[key], key
    assert want["remat"] is False and want["mesh"] is None
    assert got["compute_dtype"] == torch.bfloat16 and want["compute_dtype"] == jnp.bfloat16
    assert got["fused_dbwd"] is got["fused_skip"] is False


@pytest.mark.parametrize("remat,want", [(None, False), ("0", False), ("1", True), ("auto", None)])
def test_flagship_trainer_args_equal_the_jax_benchs(jax_bench, env, monkeypatch, remat, want):
    if remat is not None:
        env(VQGAN_BENCH_REMAT=remat)
    env(VQVAE_TPU_FUSED_DBWD="1")
    raw, size, batch, accum, on_tpu = jax_bench._flagship_raw(_Backend("cpu"))
    jax_args = _jax_trainer_args(monkeypatch, jax_bench._bench_flagship, raw, size, batch, accum,
                                 on_tpu, jnp)
    got = _port_trainer_args(monkeypatch, bench.bench_flagship)
    assert dataclasses.asdict(got["cfg"]) == dataclasses.asdict(jax_args["cfg"])
    assert got["remat"] is jax_args["remat"] is want
    for key in ("learning_rate", "seed", "steps_per_epoch"):
        assert got[key] == jax_args[key], key
    assert got["compute_dtype"] == torch.bfloat16 and jax_args["compute_dtype"] == jnp.bfloat16
    assert got["fused_dbwd"] is True and got["fused_skip"] is False


def test_each_window_holds_one_r1_step(monkeypatch, tmp_path):
    """A tiny GAN Trainer (16^2, one residual block, a narrow D, R1 every 16
    steps) through ``time_windows`` with its defaults: R1 on host steps 0,
    16, 32 and 48, one in each window, as the step's own ``r1`` sees it."""
    raw = bench.flagship_raw(False)[0]
    raw.update(image_size=16)
    raw["autoencoder"].update(num_res_blocks=1)
    raw["quantizer"].update(num_embeddings=32, embedding_dim=8)
    monkeypatch.setenv("VQVAE_TPU_LPIPS_WEIGHTS_DIR", str(tmp_path))   # random LPIPS
    with pytest.warns(UserWarning, match="LPIPS"):
        trainer = Trainer(parse_config(raw), learning_rate=1e-4, seed=0, steps_per_epoch=1000,
                          device="cpu", disc_kwargs={"channel_base": 256})
    state = trainer.init_state()
    images = torch.randint(0, 256, (4, 16, 16, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    seen = []
    real = steps.train_step

    def spy(*args, **kwargs):
        seen.append(kwargs["r1"])
        return real(*args, **kwargs)

    monkeypatch.setattr(steps, "train_step", spy)
    out = bench.time_windows(trainer, state, {"image": images})
    warmup, n, windows = bench.WARMUP, bench.STEPS, bench.WINDOWS
    assert (warmup, n, windows) == (3, 16, 3)
    assert len(seen) == warmup + n * windows == trainer.host_step
    assert [i for i, r in enumerate(seen) if r] == out["r1_at"] == [0, 16, 32, 48]
    for w in range(windows):
        assert sum(seen[warmup + w * n:warmup + (w + 1) * n]) == 1
    assert out["r1_steps"] == windows
    assert len(out["windows_s"]) == windows and all(s > 0 for s in out["windows_s"])
    assert out["finite"]


def _stub_legs(monkeypatch, legs: dict) -> list:
    """``_run_leg_subprocess`` answering from ``legs`` (a value, or an
    exception to raise); -> (the leg asked for, its time limit), in order."""
    asked = []

    def run(name, device, timeout_s):
        asked.append((name, timeout_s))
        got = legs[name]
        if isinstance(got, Exception):
            raise got
        return dict(got)

    monkeypatch.setattr(bench, "_run_leg_subprocess", run)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    return asked


FLAGSHIP = {"metric": bench.METRIC, "value": 23.5, "unit": bench.UNIT, "device": "H100",
            "card": "H100, 700.00 W", "r1_steps": 3, "peak_gib": 40.0}


def _lines(capsys) -> list:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_flagship_line_first_and_enriched_line_last(env, monkeypatch, capsys):
    asked = _stub_legs(monkeypatch, {
        "flagship": FLAGSHIP, "ema_vqvae": {"leg": "ema_vqvae", "value": 110.0},
        "standard_vqvae": {"error": "error: leg standard_vqvae rc=1: boom"},
        "entropy_vqvae": {"leg": "entropy_vqvae", "value": 105.0},
        "gan_b32_plain": {"leg": "gan_b32_plain", "value": 24.0}})
    record = bench.main([])
    lines = _lines(capsys)
    assert asked == [("flagship", bench.FLAGSHIP_TIMEOUT_S),
                     *[(name, bench.LEG_TIMEOUT_S) for name in bench.SECONDARY_LEGS]]
    assert len(lines) == 2 and lines[0] == FLAGSHIP
    assert lines[1] == record == {**FLAGSHIP, "secondary": {
        "ema_vqvae": 110.0, "standard_vqvae": "error: leg standard_vqvae rc=1: boom",
        "entropy_vqvae": 105.0, "gan_b32_plain": 24.0}}


def test_secondary_legs_run_on_the_card_only(env, monkeypatch, capsys):
    """No accumulation: no ``gan_b32_plain``; ``--device cpu``: the
    flagship line alone."""
    env(VQGAN_BENCH_ACCUM="1")
    asked = _stub_legs(monkeypatch, {"flagship": FLAGSHIP,
                                     **{n: {"value": 1.0} for n in bench.SECONDARY_LEGS}})
    assert bench.main([])["secondary"] == {n: 1.0 for n in bench.SECONDARY_LEGS
                                           if n != "gan_b32_plain"}
    assert bench.main(["--device", "cpu"]) == FLAGSHIP
    assert [name for name, _ in asked] == ["flagship", "ema_vqvae", "standard_vqvae",
                                           "entropy_vqvae", "flagship"]
    assert len(_lines(capsys)) == 2 + 1


def test_a_late_crash_re_emits_the_flagship_record(env, monkeypatch, capsys):
    _stub_legs(monkeypatch, {"flagship": FLAGSHIP, "ema_vqvae": OSError("pipe closed")})
    record = bench.main([])
    lines = _lines(capsys)
    assert len(lines) == 2 and lines[0] == FLAGSHIP
    assert lines[1] == record == {**FLAGSHIP,
                                  "secondary_error": "bench failed: OSError: pipe closed"}


def test_a_flagship_failure_is_one_line_and_a_non_zero_exit(env, monkeypatch, capsys):
    _stub_legs(monkeypatch, {"flagship": {"error": "error: leg flagship rc=1: out of memory"}})
    with pytest.raises(SystemExit) as exit_:
        bench.main([])
    assert exit_.value.code != 0
    assert _lines(capsys) == [{"metric": bench.METRIC, "value": 0.0, "unit": bench.UNIT,
                               "error": "error: leg flagship rc=1: out of memory"}]


def test_leg_record(env, monkeypatch, capsys):
    """A leg prints and returns its record; a non-finite metric fails it."""
    out = {"value": 20.0, "r1_steps": 3, "peak_gib": None, "finite": True}
    monkeypatch.setattr(bench, "bench_flagship", lambda device: dict(out))
    monkeypatch.setattr(bench, "bench_gan_plain", lambda device: dict(out, value=21.0))
    monkeypatch.setattr(bench, "bench_plain", lambda q_type, device: dict(out, finite=False))
    want = {**FLAGSHIP, "value": 20.0, "device": "cpu", "card": None, "peak_gib": None}
    assert bench.run_leg("flagship", "cpu") == want
    leg = {k: v for k, v in want.items() if k != "metric"}
    assert bench.run_leg("gan_b32_plain", "cpu") == {"leg": "gan_b32_plain", **leg,
                                                     "value": 21.0}
    with pytest.raises(RuntimeError, match="not finite"):
        bench.run_leg("ema_vqvae", "cpu")
    assert _lines(capsys) == [want, {"leg": "gan_b32_plain", **leg, "value": 21.0}]


def test_cpu_run_end_to_end(env):
    """``python -m vqvae_tpu_torch.bench --device cpu`` on the small config
    at a micro-batch of 2 (one mbstd group; the default 8 takes ~400
    CPU-seconds for the same assertions, 2 about 50): the flagship leg in a
    process of its own, one JSON line."""
    out = subprocess.run([sys.executable, "-m", "vqvae_tpu_torch.bench", "--device", "cpu"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900,
                         env={**os.environ, "OMP_NUM_THREADS": "2", "VQGAN_BENCH_BATCH": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert record["metric"] == bench.METRIC and record["unit"] == "images/sec/chip"
    assert math.isfinite(record["value"]) and record["value"] > 0
    assert record["r1_steps"] == 3
    assert record["device"] == "cpu" and record["card"] is None and record["peak_gib"] is None
