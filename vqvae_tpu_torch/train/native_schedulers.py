"""The native LR scheduler twin (counterpart of
``vqvae_tpu/train/native_schedulers.py``): ctypes over
``vqvae_tpu_torch/csrc/schedulers.cpp``, built by g++ at first use
(``ops/_build.py``), the equivalent of the reference's external
``scheduling_utils.schedulers_cpp`` (reference model.py:6): objects with a
``step(current_step) -> value`` method and an explicit ``destroy()``
(reference model.py:305-307). ``run_training`` logs its LR and destroys it
at the end. Where g++ is missing, the same object steps the Python
schedules of ``train/schedules.py`` (the same math), as the JAX package
falls back to its Python twin; ``is_native`` tells which.
"""

from __future__ import annotations

import ctypes
from typing import Optional

from vqvae_tpu_torch.ops import _build
from vqvae_tpu_torch.train.schedules import Schedule, build_lr_schedule

# the C interface of csrc/schedulers.cpp that this module binds:
# name -> (restype, argtypes)
SIGNATURES = {
    "scheduler_create_linear": (ctypes.c_void_p, [ctypes.c_double] * 4),
    "scheduler_create_cosine": (ctypes.c_void_p, [ctypes.c_double] * 4),
    "scheduler_create_linear_cosine": (ctypes.c_void_p, [ctypes.c_double] * 5),
    "scheduler_step": (ctypes.c_double, [ctypes.c_void_p, ctypes.c_double]),
    "scheduler_destroy": (None, [ctypes.c_void_p]),
}


def _library() -> Optional[ctypes.CDLL]:
    return _build.load_host_library("schedulers", SIGNATURES)


class NativeScheduler:
    """One native scheduler object (``create`` names its constructor, None
    for the constant, which has no native counterpart in scheduling_utils
    either) with ``fallback`` stepping in where the library is missing."""

    def __init__(self, create: Optional[str], args, fallback: Schedule):
        lib = _library() if create is not None else None
        self._handle = getattr(lib, create)(*map(float, args)) if lib is not None else None
        self._fallback = fallback

    def step(self, current_step: float) -> float:
        if self._handle is not None:
            return _library().scheduler_step(self._handle, float(current_step))
        return float(self._fallback(float(current_step)))

    def destroy(self) -> None:
        if self._handle is not None:
            _library().scheduler_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass

    @property
    def is_native(self) -> bool:
        return self._handle is not None


def build_native_lr_scheduler(lr: float, steps_per_epoch: int, warmup_epochs,
                              decay_epochs) -> NativeScheduler:
    """The twin of ``schedules.build_lr_schedule``, with its dispatch (the
    reference's on_train_start, model.py:163-187)."""
    fallback = build_lr_schedule(lr, steps_per_epoch, warmup_epochs, decay_epochs)
    if warmup_epochs is not None and decay_epochs is not None:
        args = (0.0, decay_epochs * steps_per_epoch, lr, lr / 2.0,
                warmup_epochs * steps_per_epoch)
        return NativeScheduler("scheduler_create_linear_cosine", args, fallback)
    if warmup_epochs is not None:
        args = (0.0, warmup_epochs * steps_per_epoch, 1e-20, lr)
        return NativeScheduler("scheduler_create_linear", args, fallback)
    if decay_epochs is not None:
        args = (0.0, decay_epochs * steps_per_epoch, lr, lr / 2.0)
        return NativeScheduler("scheduler_create_cosine", args, fallback)
    return NativeScheduler(None, (), fallback)
