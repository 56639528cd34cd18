"""What every traffic kind's driver (``cells/<kind>.py``) shares: the run's
context, what a driver hands back, and the device's clock."""

from __future__ import annotations

import gc
import random
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from benchmark import inputs

MODEL_KEYS = ("image_size", "autoencoder", "quantizer", "loss", "training")


@dataclass
class Context:
    cell: str              # the workload's name
    cfg: dict              # the configuration file, as written
    traffic: dict          # the traffic file
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float         # host clock when the run began
    # False: set up, then compare at once, with no window (``calibrate``'s
    # readings of the port on many seeds in one process)
    measure: bool = True

    @property
    def model_cfg(self) -> dict:
        """The published YAML's keys, as the port's parser takes them."""
        return {k: self.cfg[k] for k in MODEL_KEYS if k in self.cfg}


@dataclass
class Outcome:
    metrics: dict                    # end-to-end values by name (setup_s among them)
    numbers: dict                    # the numbers compared, by name
    attempted: int
    failed: int = 0
    info: dict = field(default_factory=dict)
    trace: Optional[object] = None   # trace.Trace in a traced run
    breakdown: Optional[dict] = None
    memory_peak_bytes: int = 0


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Stamp:
    """A point on the device's timeline: a CUDA event on the card, the host
    clock (after the work, which is synchronous) on the CPU."""

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        else:
            self.t = time.perf_counter()

    def ms_until(self, other: "Stamp") -> float:
        if self.event is not None:
            return self.event.elapsed_time(other.event)
        return (other.t - self.t) * 1e3


def host_pool(batches) -> list:
    """Device tensors -> host copies, pinned where a card is visible (what
    a loader hands the training step or a caller hands the API)."""
    out = []
    for b in batches:
        h = b.cpu()
        out.append(h.pin_memory() if torch.cuda.is_available() else h)
    return out


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def peak_bytes(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def sample(seed: int, n: int, k: int) -> list:
    """``k`` of ``range(n)`` (all if fewer), drawn from ``seed``, sorted."""
    rng = random.Random(inputs.derive(seed, "sample"))
    return sorted(rng.sample(range(n), min(k, n)))


def weight_specs(cfg: dict) -> dict:
    """{leaf name: shape} of every model of the configuration, from the
    plain reference's modules on the meta device."""
    from benchmark.reference.train import spec_modules
    return {f"{part}.{k}": tuple(v.shape)
            for part, module in spec_modules(cfg).items()
            for k, v in module.state_dict().items()}


def load_weights(modules: dict, weights: dict) -> None:
    """{prefix: module} <- the benchmark's weights, every key and shape
    checked (``strict``)."""
    for prefix, module in modules.items():
        own = {k[len(prefix) + 1:]: v for k, v in weights.items()
               if k.startswith(prefix + ".")}
        module.load_state_dict(own, strict=True)
