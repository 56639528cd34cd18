"""The plain reference of taming-transformers' VQGAN (Esser, Rombach, Ommer,
*Taming Transformers for High-Resolution Image Synthesis*, CVPR 2021): its
encoder, decoder and standard vector quantizer, in plain PyTorch and
float32 (convolutions and the attention's two matrix products through
``numerics``).

It follows the published equations (github.com/CompVis/taming-transformers,
``taming/modules/diffusionmodules/model.py``: ``Encoder``, ``Decoder``,
``ResnetBlock``, ``AttnBlock``, ``Downsample``, ``Upsample``, ``Normalize``;
``taming/models/vqgan.py``: ``VQModel``): GroupNorm of 32 groups with the
biased variance and eps 1e-6, SiLU, biases on every convolution, a 1x1
``nin_shortcut`` where a block changes width, single-head attention over
the h*w positions scaled by C^-1/2, downsampling by a stride-2 3x3 conv
after padding one row and column at the bottom and right, nearest x2 and a
3x3 conv for upsampling, a middle block (``block_1``, ``attn_1``,
``block_2``) in both halves, ``num_res_blocks`` + 1 blocks per decoder
level, no output tanh. ``double_z`` is false, dropout 0 and there is no
time embedding, as in the VQGAN's configs.

Names are the port's, so that one set of weights made by the benchmark
loads into both: taming's inside each half, with ``VQModel``'s
``quant_conv`` at the end of ``encoder`` and its ``post_quant_conv`` at the
start of ``decoder``; the codebook is ``quantizer.codebook.weight``
(taming's ``quantize.embedding.weight``), and GroupNorm's scale and shift
are (1, C, 1, 1) leaves (taming's are (C,)). Departure: the quantizer's
loss has taming's value, but not its split of the gradient (taming's
``legacy`` form gives the encoder's term weight 1 and the codebook's beta);
the configuration does not train, so nothing reads that gradient.

It gives the interface of ``reference/__init__.py``; it has no
``decay_names``: the configuration has no training recipe here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import numerics
from benchmark.reference.nets import _flatten, scores


class GroupNorm(nn.Module):
    """``nn.GroupNorm(32, C, eps=1e-6)``'s arithmetic: the biased variance."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(1, channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(1, channels, 1, 1))

    def forward(self, x):
        b, c, h, w = x.shape
        xg = x.float().reshape(b, self.groups, -1)
        mean = xg.mean(-1, keepdim=True)
        var = (xg - mean).square().mean(-1, keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(b, c, h, w)
        return y * self.weight + self.bias


class Conv(nn.Module):
    """A convolution with bias: 'same' padding unless ``padding`` is given."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding=None):
        super().__init__()
        self.stride = stride
        self.padding = k // 2 if padding is None else padding
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return numerics.conv2d(x, self.weight, self.bias, stride=self.stride,
                               padding=self.padding)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GroupNorm(cin)
        self.conv1 = Conv(cin, cout, 3)
        self.norm2 = GroupNorm(cout)
        self.conv2 = Conv(cout, cout, 3)
        self.nin_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.nin_shortcut is None else self.nin_shortcut(x)) + h


class AttnBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm(channels)
        self.q = Conv(channels, channels, 1)
        self.k = Conv(channels, channels, 1)
        self.v = Conv(channels, channels, 1)
        self.proj_out = Conv(channels, channels, 1)

    def forward(self, x):
        h_ = self.norm(x)
        q, k, v = self.q(h_), self.k(h_), self.v(h_)
        b, c, h, w = q.shape
        q = q.reshape(b, c, h * w).permute(0, 2, 1)             # b, hw, c
        k = k.reshape(b, c, h * w)                              # b, c, hw
        w_ = (numerics.matmul(q, k) * c ** -0.5).softmax(2)     # b, hw (q), hw (k)
        v = v.reshape(b, c, h * w)
        h_ = numerics.matmul(v, w_.permute(0, 2, 1)).reshape(b, c, h, w)
        return x + self.proj_out(h_)


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Middle(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels)
        self.attn_1 = AttnBlock(channels)
        self.block_2 = ResnetBlock(channels, channels)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


def _level(blocks, attn) -> nn.Module:
    level = nn.Module()
    level.block = nn.ModuleList(blocks)
    level.attn = nn.ModuleList(attn)
    return level


def _run_level(level, h):
    for i, block in enumerate(level.block):
        h = block(h)
        if len(level.attn) > 0:
            h = level.attn[i](h)
    return h


class Encoder(nn.Module):
    def __init__(self, ae: dict, resolution: int, out_ch: int):
        super().__init__()
        ch, nrb, mults = ae["channels"], ae["num_res_blocks"], ae["channel_multipliers"]
        self.conv_in = Conv(3, ch, 3)
        self.down = nn.ModuleList()
        block_in, res = ch, resolution
        for i, m in enumerate(mults):
            blocks, attn = [], []
            for _ in range(nrb):
                blocks.append(ResnetBlock(block_in, ch * m))
                block_in = ch * m
                if res in ae["attn_resolutions"]:
                    attn.append(AttnBlock(block_in))
            level = _level(blocks, attn)
            if i != len(mults) - 1:
                level.downsample = Downsample(block_in)
                res //= 2
            self.down.append(level)
        self.mid = Middle(block_in)
        self.norm_out = GroupNorm(block_in)
        self.conv_out = Conv(block_in, ae["z_channels"], 3)
        self.quant_conv = Conv(ae["z_channels"], out_ch, 1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            h = _run_level(level, h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.conv_out(F.silu(self.norm_out(self.mid(h))))
        return self.quant_conv(h)


class Decoder(nn.Module):
    def __init__(self, ae: dict, resolution: int, in_ch: int):
        super().__init__()
        ch, nrb, mults = ae["channels"], ae["num_res_blocks"], ae["channel_multipliers"]
        block_in = ch * mults[-1]
        res = resolution // 2 ** (len(mults) - 1)
        self.post_quant_conv = Conv(in_ch, ae["z_channels"], 1)
        self.conv_in = Conv(ae["z_channels"], block_in, 3)
        self.mid = Middle(block_in)
        up = []
        for i in reversed(range(len(mults))):
            blocks, attn = [], []
            for _ in range(nrb + 1):
                blocks.append(ResnetBlock(block_in, ch * mults[i]))
                block_in = ch * mults[i]
                if res in ae["attn_resolutions"]:
                    attn.append(AttnBlock(block_in))
            level = _level(blocks, attn)
            if i != 0:
                level.upsample = Upsample(block_in)
                res *= 2
            up.insert(0, level)
        self.up = nn.ModuleList(up)
        self.norm_out = GroupNorm(block_in)
        self.conv_out = Conv(block_in, 3, 3)

    def forward(self, z):
        h = self.mid(self.conv_in(self.post_quant_conv(z)))
        for level in reversed(self.up):
            h = _run_level(level, h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class VectorQuantizer(nn.Module):
    """The nearest code by |z - e|^2 (first index on ties), the
    straight-through estimator, loss (1 + beta) x mean |z_q - z|^2."""

    def __init__(self, n: int, d: int, beta: float):
        super().__init__()
        self.beta = beta
        self.codebook = nn.Module()
        self.codebook.weight = nn.Parameter(torch.zeros(n, d))

    def codes(self, z):
        flat, (b, h, w, _) = _flatten(z)
        return scores(flat, self.codebook.weight).argmin(1).reshape(b, h * w)

    def forward(self, z, train: bool = False, **_):
        flat, (b, h, w, d) = _flatten(z)
        codes = scores(flat.detach(), self.codebook.weight).argmin(1)
        quantized = self.codebook.weight[codes]
        loss = (quantized.detach() - flat).square().mean() + \
            self.beta * (quantized - flat.detach()).square().mean()
        quantized = flat + (quantized - flat).detach()
        return (quantized.reshape(b, h, w, d).permute(0, 3, 1, 2), codes.reshape(b, h * w),
                loss)


class VQVAE(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ae, q = cfg["autoencoder"], cfg["quantizer"]
        if ae.get("layout") != "taming" or q["type"] != "standard":
            raise ValueError(f"the taming reference takes the taming layout with the standard "
                             f"quantizer, not {ae.get('layout')!r} with {q['type']!r}")
        n, d = q["num_embeddings"], q["embedding_dim"]
        self.quantizer = VectorQuantizer(n, d, q["params"]["commitment_cost"])
        self.encoder = Encoder(ae, cfg["image_size"], d)
        self.decoder = Decoder(ae, cfg["image_size"], d)

    def forward(self, x, train: bool = False, **_):
        """Normalized NHWC images -> (NHWC reconstruction, quantizer loss, codes)."""
        z = self.encoder(x.permute(0, 3, 1, 2))
        quantized, codes, loss = self.quantizer(z, train)
        return self.decoder(quantized).permute(0, 2, 3, 1), loss, codes

    def decode_tokens(self, tokens):
        """(B, S) tokens -> NHWC images in [0, 1] (``VQModel.decode_code``,
        then the [-1, 1] -> [0, 1] map clamped)."""
        b, s = tokens.shape
        hw = int(round(s ** 0.5))
        q = self.quantizer.codebook.weight[tokens.reshape(-1).long()]
        q = q.reshape(b, hw, hw, -1).permute(0, 3, 1, 2)
        return (self.decoder(q) * 0.5 + 0.5).clamp(0, 1).permute(0, 2, 3, 1)


def latent_side(cfg: dict) -> int:
    """Every level but the last halves the image."""
    return cfg["image_size"] // 2 ** (len(cfg["autoencoder"]["channel_multipliers"]) - 1)


def tiny(cfg: dict) -> dict:
    """16^2 images, 32 channels, multipliers [1, 2] with attention at 8^2 (so
    in the encoder's second level, both middle blocks and the decoder's
    first level), one residual block, z_channels 16, 16 codes of 8 dims."""
    return dict(cfg, image_size=16,
                autoencoder={"layout": "taming", "channels": 32, "num_res_blocks": 1,
                             "channel_multipliers": [1, 2], "attn_resolutions": [8],
                             "z_channels": 16},
                quantizer=dict(cfg["quantizer"], num_embeddings=16, embedding_dim=8))
