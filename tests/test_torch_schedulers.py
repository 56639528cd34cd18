"""The port's native LR twin (``train/native_schedulers.py`` over
``csrc/schedulers.cpp``) against the JAX package's twin and the port's own
Python schedules, at sampled steps, within 1e-12; its Python fallback (a
machine without g++) too, and only there: a host source that g++ fails to
build raises; and its ``destroy()`` lifecycle.
"""

import numpy as np
import pytest

from vqvae_tpu.train import native_schedulers as jax_native
from vqvae_tpu_torch.ops import _build
from vqvae_tpu_torch.train import native_schedulers as native
from vqvae_tpu_torch.train.schedules import build_lr_schedule

CASES = [(None, None), (2.0, None), (None, 3.0), (1.0, 3.0), (0.5, 250.0)]
STEPS = [0, 0.5, 1, 3, 7, 9.99, 10, 11, 17, 29.5, 30, 31, 45, 1000, 2501]


def _values(sched):
    return np.array([sched.step(s) for s in STEPS])


@pytest.mark.parametrize("warmup,decay", CASES)
def test_native_twin_equals_jax_twin_and_python_schedule(warmup, decay):
    got = native.build_native_lr_scheduler(1e-4, 10, warmup, decay)
    want = jax_native.build_native_lr_scheduler(1e-4, 10, warmup, decay)
    try:
        assert got.is_native == (warmup is not None or decay is not None)
        python = build_lr_schedule(1e-4, 10, warmup, decay)
        np.testing.assert_allclose(_values(got), _values(want), rtol=0, atol=1e-12)
        np.testing.assert_allclose(_values(got), [python(s) for s in STEPS], rtol=0, atol=1e-12)
    finally:
        got.destroy()
        want.destroy()
    assert not got.is_native
    got.destroy()   # a second destroy is a no-op


@pytest.mark.parametrize("warmup,decay", CASES)
def test_python_fallback_without_gxx(monkeypatch, warmup, decay):
    real_which = _build.shutil.which
    monkeypatch.setattr(_build.shutil, "which",
                        lambda cmd, *a, **k: None if cmd == "g++" else real_which(cmd, *a, **k))
    got = native.build_native_lr_scheduler(1e-4, 10, warmup, decay)
    want = jax_native.build_native_lr_scheduler(1e-4, 10, warmup, decay)
    try:
        assert not got.is_native
        np.testing.assert_allclose(_values(got), _values(want), rtol=0, atol=1e-12)
    finally:
        want.destroy()


def test_a_host_source_that_fails_to_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "broken.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed to build broken.cpp"):
        _build.load_host_library("broken", {})
    assert not list((tmp_path / "_build").glob("*.so"))
