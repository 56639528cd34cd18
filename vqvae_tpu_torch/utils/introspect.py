"""Introspection (counterpart of ``vqvae_tpu/utils/introspect.py:37-88``):

- ``param_summary``: the parameter and byte table per top-level submodule,
  in the JAX package's layout (the reference's ``print_module_summary``);
- ``check_replication``: every parameter and buffer bitwise equal to rank
  0's copy (the reference's ``check_ddp_consistency``), run after init and
  after every restore.

The JAX module's ``trace`` (a profiler context) is not ported here
(ROADMAP.md queue A, item 11); ``vqvae_tpu_torch.profile_tokenizer`` drives
``torch.profiler`` for the kernel breakdowns.
"""

from __future__ import annotations

from typing import Iterator, Mapping, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from vqvae_tpu_torch.parallel.dist import reduce_device, world

Tree = Union[nn.Module, torch.Tensor, Mapping, None]


def _count(tensors) -> Tuple[int, int]:
    tensors = list(tensors)
    return (sum(t.numel() for t in tensors),
            sum(t.numel() * t.element_size() for t in tensors))


def param_summary(module: Union[nn.Module, Mapping], title: str = "params") -> str:
    """A table of the parameters and their bytes per top-level submodule (or
    per entry of a mapping of modules) that holds any, and the total: the
    JAX package's table of the same model's params tree."""
    lines = [f"{title:<40} {'params':>12} {'bytes':>14}"]
    children = dict(module.named_children()) if isinstance(module, nn.Module) else dict(module)
    total_n = total_b = 0
    for name, sub in sorted(children.items()):
        n, b = _count(sub.parameters())
        if n == 0:
            continue   # a flax params tree has no entry for a module without parameters
        total_n, total_b = total_n + n, total_b + b
        lines.append(f"{name:<40} {n:>12,} {b:>14,}")
    if isinstance(module, nn.Module):
        # parameters held by the module itself, outside any child
        own = [p for name, p in module.named_parameters(recurse=False)]
        n, b = _count(own)
        total_n, total_b = total_n + n, total_b + b
    lines.append(f"{'TOTAL':<40} {total_n:>12,} {total_b:>14,}")
    return "\n".join(lines)


def _named_tensors(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield prefix or "tensor", tree
    elif isinstance(tree, nn.Module):
        for name, t in list(tree.named_parameters()) + list(tree.named_buffers()):
            yield f"{prefix}.{name}" if prefix else name, t
    else:
        for key, sub in tree.items():
            yield from _named_tensors(sub, f"{prefix}.{key}" if prefix else str(key))


@torch.no_grad()
def check_replication(tree: Tree) -> None:
    """Raise unless every parameter and buffer of ``tree`` (a module, a
    tensor, or a mapping of names to them) equals rank 0's copy bit for
    bit. Rank 0's tensors are broadcast (one flat buffer per dtype and
    device) and compared with ``torch.equal``; the first divergent tensor
    in the tree's order is agreed on over the ranks, so every rank raises,
    naming it. A no-op at world size 1."""
    rank, size = world()
    if size == 1:
        return
    named = list(_named_tensors(tree))
    by_key: dict = {}
    for i, (_, t) in enumerate(named):
        by_key.setdefault((t.dtype, t.device), []).append(i)
    first_bad = len(named)
    for indices in by_key.values():
        flat = torch.cat([named[i][1].detach().reshape(-1) for i in indices])
        dist.broadcast(flat, src=0)
        offset = 0
        for i in indices:
            t = named[i][1]
            if not torch.equal(flat[offset:offset + t.numel()].view_as(t), t):
                first_bad = min(first_bad, i)
            offset += t.numel()
    flag = torch.tensor([first_bad], dtype=torch.int64, device=reduce_device())
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    bad = int(flag.item())
    if bad < len(named):
        raise AssertionError(f"replication mismatch at {named[bad][0]}: a rank's copy differs "
                             f"from rank 0's (seen on rank {rank} of {size})")
