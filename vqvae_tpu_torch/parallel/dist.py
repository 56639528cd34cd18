"""One process per card, joined by explicit collectives (counterpart of
``vqvae_tpu/parallel/mesh.py``).

The JAX package runs the train and eval steps under ``shard_map`` over a
1-D ``data`` mesh and reduces with ``pmean`` / ``psum`` inside them. The
port runs one process per card (``torchrun``) and makes the same reductions
at the same places with the helpers below: the EMA statistics per
micro-batch (``models/quantizers.py``), the gradients once after the
micro-batch loop, the metrics and usage (``train/steps.py``), the eval sums
(``eval/``). The model is not wrapped in ``DistributedDataParallel``: the
R1 penalty differentiates through the D's backward (``create_graph``),
which DDP does not support; adaptive lambda takes per-rank gradients on the
graph already built, before any reduction; and DDP would reduce at every
micro-batch's backward where the JAX step reduces once.

Each rank's loader reads its own rows (``data/dataset.py`` shards by the
group), so ``shard_batch``, ``replicate`` and ``local_rows`` of the JAX
module have no counterpart: there is no global array to split or to gather
rows from, and every rank builds the same initial state from the same seed
(``utils/introspect.check_replication`` verifies it).

At world size 1, and without a group, every reduction is a no-op, so a
one-process run is bit-identical to one without ``torch.distributed``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

_local_rank: Optional[int] = None


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def init_distributed(device_type: str = "cuda", backend: Optional[str] = None, *,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     init_method: str = "env://") -> Tuple[int, int]:
    """Join the process group torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``; counterpart of
    ``distributed_init_if_needed``, ``mesh.py:25-47``). The arguments, where
    given, take the place of the environment. -> ``world()``.

    Without ``RANK`` / ``WORLD_SIZE`` (and no arguments) it starts no group.
    A group that is already up is kept. ``backend`` defaults by device:
    ``nccl`` for ``cuda``, ``gloo`` for ``cpu``; gloo on CUDA tensors must
    be asked for. On CUDA the rank's card, ``cuda:LOCAL_RANK``, is set
    before the group starts, and a rank that finds no such card raises, as
    does a group that does not come up."""
    global _local_rank
    if dist.is_initialized():
        return world()
    rank = _env_int("RANK", None) if rank is None else rank
    world_size = _env_int("WORLD_SIZE", None) if world_size is None else world_size
    if rank is None or world_size is None:
        return 0, 1
    local_rank = _env_int("LOCAL_RANK", rank) if local_rank is None else local_rank
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', not {device_type!r}")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if device_type == "cuda":
        if not torch.cuda.is_available() or local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank}: no CUDA device cuda:{local_rank} "
                f"({torch.cuda.device_count()} visible)")
        torch.cuda.set_device(local_rank)
    elif backend == "nccl":
        raise ValueError("nccl reduces CUDA tensors only: use backend='gloo' on the CPU")
    dist.init_process_group(backend=backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    if not dist.is_initialized() or dist.get_world_size() != world_size:
        raise RuntimeError(f"the process group did not come up (rank {rank} of {world_size})")
    _local_rank = local_rank
    return world()


def shutdown() -> None:
    """Leave the group, if one is up."""
    global _local_rank
    if dist.is_initialized():
        dist.destroy_process_group()
    _local_rank = None


@contextlib.contextmanager
def process_group(device_type: str = "cuda") -> Iterator[Tuple[int, int]]:
    """``init_distributed(device_type)`` for the body of an entry point:
    yields ``world()`` and leaves the group at the end if it started it (a
    caller's group stays up)."""
    started = not dist.is_initialized()
    init_distributed(device_type)
    started = started and dist.is_initialized()
    try:
        yield world()
    finally:
        if started:
            shutdown()


def world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def default_device() -> torch.device:
    """The card of this rank: ``cuda:LOCAL_RANK`` under a group (the local
    rank ``init_distributed`` set, else the environment's), plain ``cuda``
    without one."""
    if not dist.is_initialized():
        return torch.device("cuda")
    local = _local_rank if _local_rank is not None else _env_int("LOCAL_RANK", 0)
    return torch.device("cuda", local)


def reduce_device() -> torch.device:
    """Where a host value goes to be reduced: this rank's card under NCCL
    (it reduces CUDA tensors only), the CPU under gloo or without a group."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def local_batch_size(cumulative_bs: int, world_size: int) -> int:
    """Each rank's batch of the global ``cumulative_bs`` (``mesh.py:61-72``);
    raises when the ranks do not divide it."""
    per_rank = cumulative_bs // world_size
    if per_rank * world_size != cumulative_bs:
        raise ValueError(f"cumulative_bs={cumulative_bs} not divisible by {world_size} ranks")
    return per_rank


def rank_seed(seed: int, rank: int) -> int:
    """A seed for ``rank``'s own random stream (augmentations, gumbel noise),
    the counterpart of folding ``axis_index`` into the key
    (``vqvae_tpu/train/steps.py:386,481``). Rank 0 keeps ``seed``, so a
    one-process run draws what it drew before; the others get a hash of
    (seed, rank) below 2**63."""
    if rank == 0:
        return seed
    state = np.random.SeedSequence([seed & (2**64 - 1), seed >> 64, rank]).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


def _all_reduce_(tensors: Iterable[Optional[torch.Tensor]], mean: bool) -> None:
    tensors = [t for t in tensors if t is not None]
    _, size = world()
    if size == 1 or not tensors:
        return
    by_key: dict = {}
    for t in tensors:
        by_key.setdefault((t.dtype, t.device), []).append(t)
    for group in by_key.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        if mean:
            flat.div_(size)
        offset = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def all_reduce_sum_(tensors: Iterable[Optional[torch.Tensor]]) -> None:
    """Sum each tensor over the ranks, in place (JAX's ``psum``): one
    collective per dtype and device, on a flat buffer. None entries are
    skipped; a no-op at world size 1."""
    _all_reduce_(tensors, mean=False)


def all_reduce_mean_(tensors: Iterable[Optional[torch.Tensor]]) -> None:
    """The mean over the ranks, in place (JAX's ``pmean``): the sum, then a
    division by the world size. A no-op at world size 1."""
    _all_reduce_(tensors, mean=True)


def barrier() -> None:
    """Wait for every rank; a no-op without a group."""
    if dist.is_initialized():
        dist.barrier()
