"""Conv ResNet encoder / decoder (counterpart of ``vqvae_tpu/models/autoencoder.py``).

NCHW-shaped tensors inside, with the reference's torch module names, so
that ``vqvae_tpu.utils.torch_convert`` and ``vqvae_tpu_torch.utils.convert``
map weights both ways. The plain forms are carried: the JAX package's exact TPU
rewrites (pool folded into a stride-2 conv, upsample folded into an
lhs-dilated conv, the fused GN-SiLU VJP, the padded output conv) are not.

GroupNorm -> SiLU: where autograd does not record (eval, serving, token
export: ``torch.is_grad_enabled()`` false, as under the API's
``inference_mode``) outside a height-sharded call (``GroupNorm.takes_kernel``),
``norm_act`` and the attention blocks' GroupNorm go to ``ops/gn_silu.gn_silu``:
on a CUDA tensor one hand-written kernel (``csrc/gn_silu.cu``) computes the
pair, or the GroupNorm alone; an input in another dtype than the module's
raises, on every device. Training under autograd and the sharded path run
the module's own form (``ops/gn_silu.gn_silu_reference``): the kernel has no
backward and no statistics across processes.

The activations' memory format (``layout``), decided here alone at the
entry of each half: channels-last (NHWC in memory) where the compute dtype
is bf16 and the half's GroupNorm takes the kernel (autograd not recording,
no sharded call), since cuDNN's bf16 convolutions on this card are NHWC
kernels that would otherwise transpose every input in and every output
back; each conv casts its weight to the input's layout in the one op that
casts its dtype, the residual adds, nearest upsampling, padding and the
attention blocks' rows keep the layout, and ``gn_silu`` takes it as it lies.
Everywhere else contiguous NCHW: fp32 (cuDNN's fp32 kernels are NCHW),
training under autograd and the sharded path.

Spans (``utils/introspect.named_scope``): ``encoder`` and ``decoder``
around each module's forward, and ``norm_act`` in ``norm_act``, the helper
every GroupNorm -> SiLU pair goes through, one span a pair whichever form
runs; ``attn`` (attribute ``positions``, h*w) around each taming attention
block; ``spatial_norm`` around each SpatialNorm call (``spatial_norm``,
with its SiLU where the block takes one), counted in
``spatial_norm.calls``.

``remat=True`` checkpoints every ``ResBlock`` (the JAX modules' ``nn.remat``,
``vqvae_tpu/models/autoencoder.py:527,563``): its activations are recomputed
in the backward pass instead of being kept. The flag lives on the block, so
the module tree and the ``state_dict`` keys do not depend on it, and it acts
only where autograd records (``torch.is_grad_enabled()``): eval and serving
run the plain forward.

Precision policy as in the JAX package: fp32 parameters, convolutions in the
compute ``dtype``, GroupNorm statistics in fp32. Parameters are drawn with
torch's default conv init, U(+-1/sqrt(fan_in)) for kernels and biases, from
an explicit ``torch.Generator``.

Two layouts (``config.AutoencoderConf.layout``), decided here alone:
``build_autoencoder`` builds a config's two halves. ``Encoder`` /
``Decoder`` are SerezD's (the JAX package's); ``TamingEncoder`` /
``TamingDecoder`` are taming-transformers'
(``taming/modules/diffusionmodules/model.py``), with taming's own module
names, conv biases everywhere, the biased GroupNorm variance (the one
``ResBlock`` serves both), a padded stride-2 conv for downsampling,
single-head attention (``AttnBlock``, span ``attn``) at the resolutions
listed, a middle block in both halves and no output tanh; ``VQModel``'s
``quant_conv`` closes the encoder and its ``post_quant_conv`` opens the
decoder, so each half meets the quantizer at the codebook's width. With
``norm_type: spatial`` (MoVQ, Kandinsky 2.2's decoder) every normalization
of the taming decoder is a ``SpatialNorm`` conditioned on the quantized
latents ``zq``, the decoder's input before ``post_quant_conv``, which the
decoder hands each block as an explicit argument.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vqvae_tpu_torch.ops.gn_silu import channels_last, gn_silu, gn_silu_reference
from vqvae_tpu_torch.utils.introspect import named_scope


class Conv2d(nn.Conv2d):
    """'same' conv that casts input and parameters to the compute dtype, the
    weight in the input's layout (channels-last or not), so that cuDNN takes
    both as they lie."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, bias: bool,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 stride: int = 1, padding: Optional[int] = None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=kernel_size // 2 if padding is None else padding,
                         bias=bias, device="meta")
        self.compute_dtype = dtype
        bound = 1.0 / math.sqrt(in_ch * kernel_size * kernel_size)
        self.weight = nn.Parameter(
            _uniform(self.weight.shape, bound, generator))
        if bias:
            self.bias = nn.Parameter(_uniform(self.bias.shape, bound, generator))

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        fmt = torch.channels_last if channels_last(x) else torch.preserve_format
        return self._conv_forward(x.to(dt), self.weight.to(dt, memory_format=fmt), bias)


def _uniform(shape, bound: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """U(-bound, bound) fp32, drawn on the CPU so that a seed gives the same
    weights on every device."""
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


class GroupNorm(nn.Module):
    """GroupNorm with the unbiased variance (``/(n-1)``) and fp32 statistics
    (``vqvae_tpu/models/autoencoder.py:138-169``); ``nn.GroupNorm`` is biased.
    ``unbiased=False`` takes the biased one (``/n``), as the taming layout
    does. Output in the compute dtype.

    ``shards`` is None but while a height-sharded call runs
    (``parallel/spatial.py``): then the statistics are summed over the
    processes (``ops/gn_silu.gn_silu_reference``)."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32, unbiased: bool = True):
        super().__init__()
        if channels % num_groups != 0:
            raise ValueError("num_channels must be divisible by num_groups")
        self.num_groups = num_groups
        self.ddof = 1 if unbiased else 0   # the variance's divisor is n - ddof
        self.eps = eps
        self.dtype = dtype
        self.shards = None
        self.weight = nn.Parameter(torch.ones(1, channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(1, channels, 1, 1))

    def takes_kernel(self) -> bool:
        """Whether a call goes to ``gn_silu``: autograd does not record and
        no sharded call runs."""
        return not torch.is_grad_enabled() and self.shards is None

    def normalize(self, x: torch.Tensor, act: bool) -> torch.Tensor:
        """``gn_silu`` of ``x`` with this module's parameters."""
        return gn_silu(x, self.weight, self.bias, self.num_groups, self.eps, self.ddof,
                       self.dtype, act)

    def forward(self, x):
        if self.takes_kernel():
            return self.normalize(x, act=False)
        return gn_silu_reference(x, self.weight, self.bias, self.num_groups, self.eps,
                                 self.ddof, self.dtype, act=False, shards=self.shards)

    def act(self, x):
        """SiLU(self(x)): ``norm_act``."""
        return norm_act(self, x)


def layout(norm, dtype: torch.dtype) -> torch.memory_format:
    """The memory format of a half's activations for this call, from its
    last norm ``norm`` (a ``GroupNorm`` or ``SpatialNorm``) and compute
    ``dtype``: channels-last where ``dtype`` is bf16 and
    ``norm.takes_kernel()``, contiguous NCHW otherwise."""
    if dtype == torch.bfloat16 and norm.takes_kernel():
        return torch.channels_last
    return torch.contiguous_format


def norm_act(norm: GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """SiLU(norm(x)), under the span ``norm_act``: ``gn_silu`` where
    ``norm.takes_kernel()``, else the module's form and ``F.silu``."""
    with named_scope("norm_act"):
        if norm.takes_kernel():
            return norm.normalize(x, act=True)
        return F.silu(norm(x))


class SpatialNorm(nn.Module):
    """MoVQ's SpatialNorm (Zheng et al., NeurIPS 2022; diffusers'
    ``SpatialNorm``, under its child names): GN(f) * conv_y(up(zq)) +
    conv_b(up(zq)), where GN is taming's GroupNorm (biased variance, an
    affine), conv_y and conv_b are 1x1 convs with bias from the quantized
    latents' ``cond_channels`` to f's ``channels``, and up is the nearest
    upsampling of zq to f's size. A 1x1 conv commutes with nearest
    upsampling, so both convs run on zq at the latents' resolution and the
    modulation reads them at (y // s, x // s) (``_modulate``): no full-size
    scale or shift is formed. Calls go through ``spatial_norm``."""

    def __init__(self, channels: int, cond_channels: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm_layer = GroupNorm(channels, dtype=dtype, unbiased=False)
        self.conv_y = Conv2d(cond_channels, channels, 1, bias=True, dtype=dtype,
                             generator=generator)
        self.conv_b = Conv2d(cond_channels, channels, 1, bias=True, dtype=dtype,
                             generator=generator)

    def takes_kernel(self) -> bool:
        return self.norm_layer.takes_kernel()

    def forward(self, f, zq):
        return spatial_norm(self, f, zq, act=False)

    def act(self, f, zq):
        """SiLU(self(f, zq))."""
        return spatial_norm(self, f, zq, act=True)


def _modulate(n: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """n * up(scale) + up(shift): ``scale`` and ``shift`` (B, C, h, w), up
    the nearest upsampling to n's (H, W) by whole factors s = H / h = W / w,
    as one broadcast ``addcmul`` over (B, C, h, s, w, s) views of n; the
    result keeps n's memory format."""
    h, w = scale.shape[2:]
    n6 = n.unflatten(3, (w, -1)).unflatten(2, (h, -1))
    out = torch.addcmul(shift[:, :, :, None, :, None], n6, scale[:, :, :, None, :, None])
    return out.flatten(4, 5).flatten(2, 3)


def spatial_norm(norm: SpatialNorm, f: torch.Tensor, zq: torch.Tensor,
                 act: bool) -> torch.Tensor:
    """``norm``'s SpatialNorm of f given zq, then SiLU where ``act``, under
    the span ``spatial_norm`` (attributes: ``elements`` and
    ``element_bytes`` of f, ``cond_elements`` of zq, ``act``), counted in
    ``spatial_norm.calls``. The GroupNorm is
    the module's own: ``gn_silu`` with the SiLU off where it
    ``takes_kernel``, the plain form under autograd."""
    spatial_norm.calls += 1
    with named_scope("spatial_norm", elements=f.numel(), element_bytes=f.element_size(),
                     cond_elements=zq.numel(), act=act):
        out = _modulate(norm.norm_layer(f), norm.conv_y(zq), norm.conv_b(zq))
        return F.silu(out) if act else out


spatial_norm.calls = 0


def _norm(channels: int, cond_channels: int, dtype: torch.dtype,
          generator: Optional[torch.Generator], unbiased: bool) -> nn.Module:
    """A ``SpatialNorm`` on ``cond_channels`` of latents where there are
    any, else a ``GroupNorm``."""
    if cond_channels:
        return SpatialNorm(channels, cond_channels, dtype, generator)
    return GroupNorm(channels, dtype=dtype, unbiased=unbiased)


class _Checkpointed(nn.Module):
    """A block whose ``_forward`` is checkpointed where autograd records and
    ``remat`` is set; the plain forward elsewhere. ``cond``: the latents a
    SpatialNorm block takes, or nothing."""

    def forward(self, x, *cond):
        if self.remat and torch.is_grad_enabled():
            # the block draws no random numbers: no RNG state to replay
            return checkpoint(self._forward, x, *cond, use_reentrant=False,
                              preserve_rng_state=False)
        return self._forward(x, *cond)


class ResBlock(_Checkpointed):
    """Pre-activation residual block: (GN -> SiLU -> 3x3 conv) x 2, a 1x1
    shortcut when channels change (reference autoencoder.py:42-77). SerezD's
    by default: bias-free convs, the unbiased GroupNorm variance, the
    shortcut named ``conv_shortcut``. ``bias``, ``unbiased`` and
    ``shortcut_name`` (the attribute, and so the ``state_dict`` key) give
    taming's ``ResnetBlock`` (``_taming_block``); ``cond_channels`` > 0
    MoVQ's (diffusers' ``ResnetBlockCondNorm2D``): both norms SpatialNorms
    of the latents the block is called with."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, remat: bool = False,
                 bias: bool = False, unbiased: bool = True,
                 shortcut_name: str = "conv_shortcut", cond_channels: int = 0):
        super().__init__()
        self.remat = remat
        self.shortcut_name = shortcut_name
        self.norm1 = _norm(in_ch, cond_channels, dtype, generator, unbiased)
        self.conv1 = Conv2d(in_ch, out_ch, 3, bias=bias, dtype=dtype, generator=generator)
        self.norm2 = _norm(out_ch, cond_channels, dtype, generator, unbiased)
        self.conv2 = Conv2d(out_ch, out_ch, 3, bias=bias, dtype=dtype, generator=generator)
        setattr(self, shortcut_name, Conv2d(in_ch, out_ch, 1, bias=bias, dtype=dtype,
                                            generator=generator) if in_ch != out_ch else None)

    def _forward(self, x, *cond):
        residual = self.conv1(self.norm1.act(x, *cond))
        residual = self.conv2(self.norm2.act(residual, *cond))
        shortcut = getattr(self, self.shortcut_name)
        if shortcut is not None:
            x = shortcut(x)
        return x + residual


class Downsample(nn.Module):
    """2x2 average pool, stride 2 (reference autoencoder.py:80-91)."""

    def forward(self, x):
        return F.avg_pool2d(x, 2)


class Upsample(nn.Module):
    """Nearest x2 then a 3x3 conv with bias (reference autoencoder.py:94-106)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, bias=True, dtype=dtype, generator=generator)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Encoder(nn.Module):
    """stem 3x3 -> per multiplier [num_res_blocks ResBlocks + Downsample] ->
    num_res_blocks final ResBlocks -> GN -> SiLU -> 1x1 conv; fp32 output
    (reference autoencoder.py:109-143). ``remat``: checkpoint each ResBlock."""

    def __init__(self, channels: int, num_res_blocks: int,
                 channel_multipliers: Sequence[int], embedding_dim: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.conv_in = Conv2d(3, channels, 3, bias=False, dtype=dtype, generator=generator)
        blocks = []
        ch = channels
        for mult in channel_multipliers:
            for _ in range(num_res_blocks):
                blocks.append(ResBlock(ch, channels * mult, dtype, generator, remat))
                ch = channels * mult
            blocks.append(Downsample())
        self.blocks = nn.Sequential(*blocks)
        self.final_residual = nn.Sequential(
            *[ResBlock(ch, ch, dtype, generator, remat) for _ in range(num_res_blocks)])
        self.norm = GroupNorm(ch, dtype=dtype)
        self.conv_out = Conv2d(ch, embedding_dim, 1, bias=True, dtype=dtype,
                               generator=generator)

    def forward(self, x):
        with named_scope("encoder", images=x.shape[0]):
            x = self.conv_in(x.to(self.dtype, memory_format=layout(self.norm, self.dtype)))
            x = self.final_residual(self.blocks(x))
            return self.conv_out(norm_act(self.norm, x)).float()


class Decoder(nn.Module):
    """Mirror of the encoder with nearest x2 upsampling and a final tanh in
    fp32 (reference autoencoder.py:146-180). ``remat``: checkpoint each
    ResBlock."""

    def __init__(self, channels: int, num_res_blocks: int,
                 channel_multipliers: Sequence[int], embedding_dim: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        ch = channels * channel_multipliers[-1]
        self.conv_in = Conv2d(embedding_dim, ch, 3, bias=True, dtype=dtype,
                              generator=generator)
        self.initial_residual = nn.Sequential(
            *[ResBlock(ch, ch, dtype, generator, remat) for _ in range(num_res_blocks)])
        blocks = []
        for i in reversed(range(len(channel_multipliers))):
            ch_out = channels * channel_multipliers[i - 1] if i > 0 else channels
            for _ in range(num_res_blocks):
                blocks.append(ResBlock(ch, ch_out, dtype, generator, remat))
                ch = ch_out
            blocks.append(Upsample(ch, dtype, generator))
        self.blocks = nn.Sequential(*blocks)
        self.norm = GroupNorm(ch, dtype=dtype)
        self.conv_out = Conv2d(ch, 3, 3, bias=True, dtype=dtype, generator=generator)

    def forward(self, x):
        with named_scope("decoder", images=x.shape[0]):
            x = self.conv_in(x.to(self.dtype, memory_format=layout(self.norm, self.dtype)))
            x = self.blocks(self.initial_residual(x))
            return torch.tanh(self.conv_out(norm_act(self.norm, x)).float())


# taming-transformers' layout (taming/modules/diffusionmodules/model.py)


def _taming_block(in_ch: int, out_ch: int, dtype: torch.dtype,
                  generator: Optional[torch.Generator], remat: bool,
                  cond_channels: int = 0) -> ResBlock:
    """``ResnetBlock`` as the VQGAN builds it (no time embedding, dropout
    0): 3x3 convs with bias, a 1x1 ``nin_shortcut`` with bias when channels
    change, the biased GroupNorm variance; SpatialNorms where
    ``cond_channels``."""
    return ResBlock(in_ch, out_ch, dtype, generator, remat, bias=True, unbiased=False,
                    shortcut_name="nin_shortcut", cond_channels=cond_channels)


def _pointwise(conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv applied to (B, positions, C) rows: a matrix product in the
    conv's compute dtype."""
    dt = conv.compute_dtype
    return F.linear(x.to(dt), conv.weight.to(dt).flatten(1), conv.bias.to(dt))


class AttnBlock(_Checkpointed):
    """``AttnBlock``: single-head self-attention over the h*w positions,
    x + proj_out(softmax(q k^T C^-1/2) v) with q, k, v 1x1 convs (with bias)
    of GroupNorm(x) (no SiLU), under the span ``attn``. The 1x1 convs run
    as matrix products on (B, h*w, C) rows, the attention as
    ``F.scaled_dot_product_attention`` with one head of C channels. The rows
    and the output are views of a channels-last x; the sum keeps x's
    layout. ``cond_channels`` > 0: the norm is a SpatialNorm of the latents
    the block is called with (MoVQ)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, remat: bool = False,
                 cond_channels: int = 0):
        super().__init__()
        self.remat = remat
        self.norm = _norm(channels, cond_channels, dtype, generator, unbiased=False)
        self.q = Conv2d(channels, channels, 1, bias=True, dtype=dtype, generator=generator)
        self.k = Conv2d(channels, channels, 1, bias=True, dtype=dtype, generator=generator)
        self.v = Conv2d(channels, channels, 1, bias=True, dtype=dtype, generator=generator)
        self.proj_out = Conv2d(channels, channels, 1, bias=True, dtype=dtype,
                               generator=generator)

    def _forward(self, x, *cond):
        b, c, h, w = x.shape
        with named_scope("attn", positions=h * w):
            rows = self.norm(x, *cond).permute(0, 2, 3, 1).reshape(b, h * w, c)
            q, k, v = (_pointwise(m, rows)[:, None] for m in (self.q, self.k, self.v))
            out = _pointwise(self.proj_out, F.scaled_dot_product_attention(q, k, v)[:, 0])
            return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class TamingDownsample(nn.Module):
    """``Downsample``: zero padding of one row and column at the bottom and
    right, then a 3x3 stride-2 conv with bias."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, bias=True, dtype=dtype, generator=generator,
                           stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class TamingMiddle(nn.Module):
    """``mid``: ``block_1`` -> ``attn_1`` -> ``block_2`` at the lowest
    resolution, in both halves; SpatialNorms where ``cond_channels``."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, remat: bool = False,
                 cond_channels: int = 0):
        super().__init__()
        self.block_1 = _taming_block(channels, channels, dtype, generator, remat, cond_channels)
        self.attn_1 = AttnBlock(channels, dtype, generator, remat, cond_channels)
        self.block_2 = _taming_block(channels, channels, dtype, generator, remat, cond_channels)

    def forward(self, x, *cond):
        return self.block_2(self.attn_1(self.block_1(x, *cond), *cond), *cond)


def _level(blocks: list, attn: list) -> nn.Module:
    """One resolution's ``block`` and ``attn`` lists (taming's ``down[i]`` /
    ``up[i]``); an attention block follows each residual block where the
    resolution takes attention."""
    level = nn.Module()
    level.block = nn.ModuleList(blocks)
    level.attn = nn.ModuleList(attn)
    return level


def _run_level(level: nn.Module, x: torch.Tensor, *cond) -> torch.Tensor:
    for i, block in enumerate(level.block):
        x = block(x, *cond)
        if len(level.attn):
            x = level.attn[i](x, *cond)
    return x


class TamingEncoder(nn.Module):
    """``Encoder`` (``double_z`` false) followed by ``quant_conv``: conv_in
    -> per multiplier [``num_res_blocks`` residual blocks (each followed by
    attention where the resolution is in ``attn_resolutions``) + a
    downsample but at the last level] -> ``mid`` -> GN -> SiLU -> 3x3 conv
    to ``z_channels`` -> 1x1 ``quant_conv`` to ``out_channels``; fp32
    output. ``resolution``: the image side the levels' resolutions count
    from."""

    def __init__(self, channels: int, num_res_blocks: int,
                 channel_multipliers: Sequence[int], attn_resolutions: Sequence[int],
                 resolution: int, z_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.conv_in = Conv2d(3, channels, 3, bias=True, dtype=dtype, generator=generator)
        self.down = nn.ModuleList()
        ch, res = channels, resolution
        for i, mult in enumerate(channel_multipliers):
            blocks, attn = [], []
            for _ in range(num_res_blocks):
                blocks.append(_taming_block(ch, channels * mult, dtype, generator, remat))
                ch = channels * mult
                if res in attn_resolutions:
                    attn.append(AttnBlock(ch, dtype, generator, remat))
            level = _level(blocks, attn)
            if i != len(channel_multipliers) - 1:
                level.downsample = TamingDownsample(ch, dtype, generator)
                res //= 2
            self.down.append(level)
        self.mid = TamingMiddle(ch, dtype, generator, remat)
        self.norm_out = GroupNorm(ch, dtype=dtype, unbiased=False)
        self.conv_out = Conv2d(ch, z_channels, 3, bias=True, dtype=dtype, generator=generator)
        self.quant_conv = Conv2d(z_channels, out_channels, 1, bias=True, dtype=dtype,
                                 generator=generator)

    def forward(self, x):
        with named_scope("encoder", images=x.shape[0]):
            x = self.conv_in(x.to(self.dtype, memory_format=layout(self.norm_out, self.dtype)))
            for level in self.down:
                x = _run_level(level, x)
                if hasattr(level, "downsample"):
                    x = level.downsample(x)
            x = self.conv_out(norm_act(self.norm_out, self.mid(x)))
            return self.quant_conv(x).float()


class TamingDecoder(nn.Module):
    """1x1 ``post_quant_conv`` from ``in_channels`` to ``z_channels``, then
    ``Decoder``: conv_in -> ``mid`` -> per multiplier from the last
    [``num_res_blocks`` + 1 residual blocks (each followed by attention
    where the resolution is in ``attn_resolutions``) + nearest x2 and a 3x3
    conv but at the first level] -> GN -> SiLU -> 3x3 conv to RGB; fp32
    output with no tanh. ``norm_type`` ``spatial``: every GN a SpatialNorm
    of the decoder's input zq (``in_channels``), MoVQ's decoder."""

    def __init__(self, channels: int, num_res_blocks: int,
                 channel_multipliers: Sequence[int], attn_resolutions: Sequence[int],
                 resolution: int, z_channels: int, in_channels: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, remat: bool = False,
                 norm_type: str = "group"):
        super().__init__()
        self.dtype = dtype
        self.spatial = norm_type == "spatial"
        cond = in_channels if self.spatial else 0
        ch = channels * channel_multipliers[-1]
        res = resolution // 2 ** (len(channel_multipliers) - 1)
        self.post_quant_conv = Conv2d(in_channels, z_channels, 1, bias=True, dtype=dtype,
                                      generator=generator)
        self.conv_in = Conv2d(z_channels, ch, 3, bias=True, dtype=dtype, generator=generator)
        self.mid = TamingMiddle(ch, dtype, generator, remat, cond)
        up = []
        for i in reversed(range(len(channel_multipliers))):
            blocks, attn = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(_taming_block(ch, channels * channel_multipliers[i], dtype,
                                           generator, remat, cond))
                ch = channels * channel_multipliers[i]
                if res in attn_resolutions:
                    attn.append(AttnBlock(ch, dtype, generator, remat, cond))
            level = _level(blocks, attn)
            if i != 0:
                level.upsample = Upsample(ch, dtype, generator)
                res *= 2
            up.insert(0, level)
        self.up = nn.ModuleList(up)
        self.norm_out = _norm(ch, cond, dtype, generator, unbiased=False)
        self.conv_out = Conv2d(ch, 3, 3, bias=True, dtype=dtype, generator=generator)

    def forward(self, x):
        with named_scope("decoder", images=x.shape[0]):
            x = x.to(self.dtype, memory_format=layout(self.norm_out, self.dtype))
            # a SpatialNorm's zq: the quantized latents, before post_quant_conv
            cond = (x,) if self.spatial else ()
            h = self.mid(self.conv_in(self.post_quant_conv(x)), *cond)
            for level in reversed(self.up):
                h = _run_level(level, h, *cond)
                if hasattr(level, "upsample"):
                    h = level.upsample(h)
            return self.conv_out(self.norm_out.act(h, *cond)).float()


def build_autoencoder(ae, image_size: int, out_channels: int, embedding_dim: int,
                      dtype: torch.dtype = torch.float32,
                      generator: Optional[torch.Generator] = None,
                      remat: bool = False) -> Tuple[nn.Module, nn.Module]:
    """(encoder, decoder) for a config's ``autoencoder`` block ``ae``, in its
    layout: the encoder emits ``out_channels``, the decoder takes
    ``embedding_dim``; ``image_size`` is the side the taming layout counts
    its resolutions from, and its ``norm_type`` the decoder's norms. The JAX
    package's config, which tests hand in too, has no ``layout``: SerezD's."""
    shape = (ae.channels, ae.num_res_blocks, tuple(ae.channel_multipliers))
    if getattr(ae, "layout", "serezd") == "taming":
        shape += (tuple(ae.attn_resolutions), image_size, ae.z_channels)
        return (TamingEncoder(*shape, out_channels, dtype, generator, remat),
                TamingDecoder(*shape, embedding_dim, dtype, generator, remat, ae.norm_type))
    return (Encoder(*shape, out_channels, dtype, generator, remat),
            Decoder(*shape, embedding_dim, dtype, generator, remat))
