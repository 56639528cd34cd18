"""Height-sharded tokenizer inference over ``torch.distributed`` (counterpart
of ``vqvae_tpu/parallel/spatial.py``).

An image whose activations exceed one card is split by rows: process ``r``
of ``n`` holds rows ``[r H / n, (r + 1) H / n)`` of every image and runs the
port's own ``Encoder`` / ``Decoder`` on them. Where the JAX package lets
GSPMD insert the halo exchanges and the GroupNorm all-reduces, the port
makes them explicit, as hooks around its modules for the length of a call:

- every 3x3 convolution first receives one row from each neighbour (zeros
  at the image's top and bottom edges) and pads only the width itself, so
  its rows are those of the whole image's convolution; this includes the
  convolution after ``Upsample``'s nearest x2. 1x1 convolutions, SiLU, the
  2x2 average pools (aligned to the shards, since ``H`` divides by ``n
  2**levels``) and the quantizer are local;
- every ``GroupNorm`` sums over the processes in its two passes, first the
  sum for the mean, then the sum of the centred squares, so its unbiased
  variance is the whole image's (``models/autoencoder.py``).

The nearest-code kernel B1 runs on each process's own latent rows. The JAX
package must take the XLA path there (a Pallas call is opaque to the GSPMD
partitioner); the port has no such limit. Tokens (and ``quantize``'s
latents) are gathered in row order and are the same on every process (JAX's
replicated ``P()``); the images of ``reconstruct`` and
``reconstruct_from_tokens`` stay each process's slab (JAX's height-sharded
``out_spec``), so that no process ever holds a whole image's output.

The exchanges are all-reduces (a process's rows added into zeros at its
place): one collective that NCCL and gloo both run on CUDA tensors (gloo
reduces CUDA tensors but does not gather them), exact, since x + 0 = x.

At world size 1, or without a group, the call is the plain model's, bit for
bit.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator

import torch
import torch.distributed as dist
from torch import nn

from vqvae_tpu_torch.models.autoencoder import GroupNorm
from vqvae_tpu_torch.models.preprocess import denormalize, to_nchw, to_nhwc
from vqvae_tpu_torch.models.quantizers import codes_to_vec

METHODS = ("get_tokens", "quantize", "reconstruct", "reconstruct_from_tokens")


class HeightShards:
    """This process's place among the ``size`` processes of ``group`` that
    split the image height, and the collectives the hooks need."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the processes, in place; -> ``t``."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every process's ``t`` (equal shapes) concatenated along ``dim`` in
        rank order."""
        parts = t.new_zeros((self.size, *t.shape))
        parts[self.rank] = t
        self.sum(parts)
        return torch.cat(parts.unbind(0), dim)

    def halo(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW rows of this process -> the same with one row of each
        neighbour above and below (zeros at the image's edges)."""
        edges = torch.cat([x[:, :, :1], x[:, :, -1:]], 2)
        every = self.gather(edges.unsqueeze(0), 0)   # (size, B, C, 2, W)
        zero = torch.zeros_like(x[:, :, :1])
        above = every[self.rank - 1, :, :, 1:] if self.rank > 0 else zero
        below = every[self.rank + 1, :, :, :1] if self.rank < self.size - 1 else zero
        return torch.cat([above, x, below], 2)


def _halo_hook(shards: HeightShards):
    def hook(module, args):
        return (shards.halo(args[0]),) + tuple(args[1:])
    return hook


@contextlib.contextmanager
def sharded(model: nn.Module, shards: HeightShards) -> Iterator[None]:
    """While entered, the encoder's and decoder's 3x3 convolutions exchange
    halo rows and pad only the width, and their GroupNorms sum their
    statistics over ``shards``; everything is restored on exit."""
    modules = [m for part in (model.encoder, model.decoder) for m in part.modules()]
    convs = [m for m in modules if isinstance(m, nn.Conv2d) and m.kernel_size[0] > 1]
    norms = [m for m in modules if isinstance(m, GroupNorm)]
    handles, paddings = [], [c.padding for c in convs]
    try:
        for conv in convs:
            if conv.kernel_size[0] != 3 or conv.padding[0] != 1:
                raise ValueError(f"height sharding takes 3x3 'same' convolutions, not "
                                 f"{conv.kernel_size} with padding {conv.padding}")
            handles.append(conv.register_forward_pre_hook(_halo_hook(shards)))
            conv.padding = (0, conv.padding[1])
        for norm in norms:
            norm.shards = shards
        yield
    finally:
        for handle in handles:
            handle.remove()
        for conv, padding in zip(convs, paddings):
            conv.padding = padding
        for norm in norms:
            norm.shards = None


def shard_rows(images: torch.Tensor, group=None, dim: int = 1) -> torch.Tensor:
    """This process's rows of ``images`` (dim ``dim``, NHWC's height by
    default): the ``r``-th of ``n`` equal slabs; the whole batch without a
    group."""
    if not dist.is_initialized():
        return images
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    rows = images.shape[dim] // size
    return images.narrow(dim, rank * rows, rows)


def make_spatial_apply(model, method: str = "get_tokens", group=None, **method_kw):
    """``fn(x) -> output`` that runs ``model.<method>`` with the image height
    split over the processes of ``group`` (the default group if None).

    ``x`` is this process's slab: NHWC images ``[B, H / n, W, C]`` (rows ``[r
    H / n, (r + 1) H / n)``, see ``shard_rows``), or, for
    ``reconstruct_from_tokens``, its rows of the token grid, ``(B, S / n)``.
    ``get_tokens`` -> ``(B, S)`` tokens and ``quantize`` -> ``(B, S, D)``
    latents, the whole image's on every process; ``reconstruct`` and
    ``reconstruct_from_tokens`` -> this process's slab of the images.
    ``method_kw`` goes to the method (``deterministic=True`` for the gumbel
    tokenizer).

    The full height must divide by ``n * 2**levels`` and the token grid's
    height by ``n``, or the call raises (the JAX package's messages). The
    gumbel quantizer runs deterministic tokens only: its sampled tokens and
    its ``quantize`` / ``reconstruct`` draw noise. Without a group, or at
    world size 1, ``fn`` is the plain method.
    """
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, not {method!r}")
    gumbel = model.quantizer_type == "gumbel"
    if gumbel and not (method == "reconstruct_from_tokens"
                       or (method == "get_tokens" and method_kw.get("deterministic"))):
        raise ValueError("spatial sharding runs the gumbel quantizer's deterministic tokens "
                         "only (get_tokens with deterministic=True, reconstruct_from_tokens)")
    plain = getattr(model, method)
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return lambda x: plain(x, **method_kw)
    shards = HeightShards(group)
    n = shards.size
    levels = len(model.encoder.blocks) // (len(model.encoder.final_residual) + 1)
    h_align = n * 2 ** levels

    @torch.inference_mode()
    def apply(x: torch.Tensor) -> torch.Tensor:
        if method == "reconstruct_from_tokens":
            s = x.shape[1] * n
            hw = math.isqrt(s)
            if hw * hw != s:
                raise ValueError(f"{n} slabs of {x.shape[1]} tokens make no square token grid")
            if hw % n != 0:
                raise ValueError(f"token grid height {hw} not divisible by {n} 'data' shards")
            with sharded(model, shards):
                quantized = codes_to_vec(model.quantizer.codebook.weight, x)
                b, _, d = quantized.shape
                out = model.decoder(to_nchw(quantized.reshape(b, hw // n, hw, d)))
            return denormalize(to_nhwc(out))
        h = x.shape[1] * n
        if h % h_align != 0:
            raise ValueError(f"image height {h} must be divisible by n_shards * 2**levels = "
                             f"{n} * {2 ** levels} = {h_align}")
        with sharded(model, shards):
            out = plain(x, **method_kw)
        if method in ("get_tokens", "quantize"):
            return shards.gather(out, 1)
        return out

    return apply

