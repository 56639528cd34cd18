"""Step-wise LR schedules (counterpart of ``vqvae_tpu/train/schedules.py``),
as plain Python functions of the global step: the port sets each step's LR
on the host before the optimizer step, so no schedule runs on the card.

Semantics (the reference's scheduling_utils):
- linear(start_step, stop_step, v0, v1): linear ramp, clamped outside range.
- cosine(start_step, stop_step, v0, v1): half-cosine from v0 to v1, clamped.
- linear_cosine(start, stop, v_peak, v_end, warmup_end): linear 0 -> v_peak on
  [start, warmup_end], cosine v_peak -> v_end on [warmup_end, stop].
"""

from __future__ import annotations

import math
from typing import Callable, Optional

Schedule = Callable[[int], float]


def _fraction(step, start_step: float, stop_step: float) -> float:
    t = (float(step) - start_step) / max(stop_step - start_step, 1e-9)
    return min(max(t, 0.0), 1.0)


def linear_schedule(start_step: float, stop_step: float, v0: float, v1: float) -> Schedule:
    def fn(step):
        return v0 + (v1 - v0) * _fraction(step, start_step, stop_step)
    return fn


def cosine_schedule(start_step: float, stop_step: float, v0: float, v1: float) -> Schedule:
    def fn(step):
        t = _fraction(step, start_step, stop_step)
        return v1 + (v0 - v1) * 0.5 * (1.0 + math.cos(math.pi * t))
    return fn


def linear_cosine_schedule(start_step: float, stop_step: float, v_peak: float,
                           v_end: float, warmup_end: float) -> Schedule:
    warm = linear_schedule(start_step, warmup_end, 0.0, v_peak)
    decay = cosine_schedule(warmup_end, stop_step, v_peak, v_end)

    def fn(step):
        return warm(step) if step < warmup_end else decay(step)
    return fn


def constant_schedule(v: float) -> Schedule:
    def fn(step):
        return float(v)
    return fn


def build_lr_schedule(lr: float, steps_per_epoch: int, warmup_epochs: Optional[float],
                      decay_epochs: Optional[float]) -> Schedule:
    """LR schedule dispatch of the reference's on_train_start
    (model.py:163-187): warmup+decay -> LinearCosine(lr -> lr/2); warmup only
    -> Linear(1e-20 -> lr); decay only -> Cosine(lr -> lr/2); neither ->
    constant lr."""
    if warmup_epochs is not None and decay_epochs is not None:
        return linear_cosine_schedule(0.0, decay_epochs * steps_per_epoch, lr, lr / 2.0,
                                      warmup_epochs * steps_per_epoch)
    if warmup_epochs is not None:
        return linear_schedule(0.0, warmup_epochs * steps_per_epoch, 1e-20, lr)
    if decay_epochs is not None:
        return cosine_schedule(0.0, decay_epochs * steps_per_epoch, lr, lr / 2.0)
    return constant_schedule(lr)


def build_gumbel_schedules(temp: float, kl_cost: float, steps_per_epoch: int,
                           kl_warmup_epochs: Optional[float], temp_decay_epochs: Optional[float],
                           temp_final: Optional[float]):
    """(temp_schedule, kl_schedule) of the gumbel quantizer (reference
    model.py:189-200): KL cost cosine 0 -> kl_cost over the warmup, the
    temperature cosine temp -> temp_final over its decay; constants without
    them."""
    if kl_warmup_epochs is not None:
        kl_sched = cosine_schedule(0.0, int(kl_warmup_epochs * steps_per_epoch), 0.0, kl_cost)
    else:
        kl_sched = constant_schedule(kl_cost)
    if temp_decay_epochs is not None and temp_final is not None:
        temp_sched = cosine_schedule(0.0, int(temp_decay_epochs * steps_per_epoch), temp,
                                     temp_final)
    else:
        temp_sched = constant_schedule(temp)
    return temp_sched, kl_sched
