"""The traced run's reduction from ``torch.profiler``'s trace to what the
per-layer readers take: device busy time (the union of every kernel,
memcpy and memset interval), the window's length, device time by kernel
name, and the idle gaps labelled by what the host was doing (the innermost
host span or operator open at the gap's start).

``Trace`` is what a per-layer reader (``metrics/<name>.py``) receives.
"""

from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

import torch

TOP = 10


@dataclass
class Trace:
    """What one traced window gave. Times in seconds."""
    kind: str                       # the traffic's kind: train, tokenize, detokenize
    window_s: float                 # the traced window, host clock
    busy_s: float = 0.0             # union of device intervals
    kernels: dict = field(default_factory=dict)   # name -> (launches, device seconds)
    step_ms: list = field(default_factory=list)   # (label, ms) per step, CUDA events
    images: int = 0                 # images in the window
    flops_per_image: Optional[float] = None
    counters: dict = field(default_factory=dict)  # launch counts in the window
    shapes: dict = field(default_factory=dict)    # e.g. {"b2": (M, N, D)}
    idle_gaps: list = field(default_factory=list)

    def kernel_seconds(self, *names: str, exclude: tuple = ()) -> float:
        """Device seconds of the kernels whose names hold any of ``names``
        and none of ``exclude``."""
        return sum(s for k, (_, s) in self.kernels.items()
                   if any(n in k for n in names) and not any(x in k for x in exclude))


@contextmanager
def profiled(enabled: bool):
    """A ``torch.profiler`` session over the block (CPU and CUDA activity),
    or nothing. Yields the profiler or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def reduce(prof, trace: Trace) -> dict:
    """Fill ``trace`` from the profiler and return the breakdown:
    {"device_ops": [[name, seconds], ...], "idle_gaps": [[label, seconds], ...]}."""
    events = prof.events()
    device, host = [], []
    for e in events:
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append((span, e.name))
        else:
            host.append((span, e.name))
    per_kernel = defaultdict(lambda: [0, 0.0])
    for (a, b), name in device:
        per_kernel[name][0] += 1
        per_kernel[name][1] += (b - a) / 1e6
    trace.kernels = {k: (n, s) for k, (n, s) in per_kernel.items()}
    trace.busy_s = _union([span for span, _ in device]) / 1e6
    trace.idle_gaps = _gaps(sorted(span for span, _ in device), host)
    top = sorted(trace.kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {"device_ops": [[k, s] for k, (_, s) in top],
            "idle_gaps": [[label, s] for label, s in trace.idle_gaps[:TOP]]}


def _gaps(device_spans, host) -> list:
    """The idle gaps between device work, longest first, each labelled by
    the innermost host event open at its start."""
    gaps, end = [], None
    for a, b in device_spans:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:TOP]:
        open_ = [(s, name) for s, name in host if s[0] <= a < s[1]]
        label = min(open_, key=lambda x: x[0][1] - x[0][0])[1] if open_ else "host"
        out.append((label, (b - a) / 1e6))
    return out
