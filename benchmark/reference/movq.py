"""The plain reference of MoVQ (Zheng, Vuong, Cai, Phung, *MoVQ: Modulating
Quantized Vectors for High-Fidelity Image Generation*, NeurIPS 2022), the VQ
autoencoder Kandinsky 2.1 / 2.2 decode through, as diffusers ships it
(``VQModel`` with ``norm_type="spatial"``): its encoder, decoder and
standard vector quantizer, in plain PyTorch and float32 (convolutions and
the attention's two matrix products through ``numerics``).

The encoder and the quantizer are taming-transformers' (``taming.py``). The
decoder follows diffusers' ``Decoder`` with ``norm_type="spatial"``
(``models/autoencoders/vae.py``; ``ResnetBlockCondNorm2D``, ``Attention``
with ``spatial_norm_dim``, ``SpatialNorm``): taming's decoder with every
GroupNorm (both of each residual block, each attention block's, the last
one) a SpatialNorm conditioned on the quantized latents zq, the decoder's
input before ``post_quant_conv`` (``VQModel.decode``):

    SpatialNorm(f, zq) = GN(f) * conv_y(up(zq)) + conv_b(up(zq))

with GN ``nn.GroupNorm(32, C, eps=1e-6)``, conv_y and conv_b 1x1 convs with
bias from zq's channels to C, and up ``F.interpolate(zq, size=f's,
mode="nearest")``: written the published way, at full size (the port runs
the 1x1 convs at the latents' resolution). The attention blocks have the
SpatialNorm and no GroupNorm of their own; SiLU follows each residual
block's norms and the last one.

Names are the port's: taming's inside each half (``reference/taming.py``),
each SpatialNorm under the block's norm (``norm1``, ``norm2``, ``norm``,
``norm_out``) with diffusers' children ``norm_layer``, ``conv_y`` and
``conv_b``. Departures: taming's (the quantizer loss's gradient split).

It gives the interface of ``reference/__init__.py``; it has no
``decay_names``: the configuration has no training recipe here.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from benchmark.reference import numerics, taming
from benchmark.reference.taming import Conv, GroupNorm, Upsample, _level, latent_side  # noqa: F401


class SpatialNorm(nn.Module):
    def __init__(self, channels: int, zq_channels: int):
        super().__init__()
        self.norm_layer = GroupNorm(channels)
        self.conv_y = Conv(zq_channels, channels, 1)
        self.conv_b = Conv(zq_channels, channels, 1)

    def forward(self, f, zq):
        zq = F.interpolate(zq, size=f.shape[-2:], mode="nearest")
        return self.norm_layer(f) * self.conv_y(zq) + self.conv_b(zq)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, zq_channels: int):
        super().__init__()
        self.norm1 = SpatialNorm(cin, zq_channels)
        self.conv1 = Conv(cin, cout, 3)
        self.norm2 = SpatialNorm(cout, zq_channels)
        self.conv2 = Conv(cout, cout, 3)
        self.nin_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x, zq):
        h = self.conv1(F.silu(self.norm1(x, zq)))
        h = self.conv2(F.silu(self.norm2(h, zq)))
        return (x if self.nin_shortcut is None else self.nin_shortcut(x)) + h


class AttnBlock(nn.Module):
    def __init__(self, channels: int, zq_channels: int):
        super().__init__()
        self.norm = SpatialNorm(channels, zq_channels)
        self.q = Conv(channels, channels, 1)
        self.k = Conv(channels, channels, 1)
        self.v = Conv(channels, channels, 1)
        self.proj_out = Conv(channels, channels, 1)

    def forward(self, x, zq):
        h_ = self.norm(x, zq)
        q, k, v = self.q(h_), self.k(h_), self.v(h_)
        b, c, h, w = q.shape
        q = q.reshape(b, c, h * w).permute(0, 2, 1)             # b, hw, c
        k = k.reshape(b, c, h * w)                              # b, c, hw
        w_ = (numerics.matmul(q, k) * c ** -0.5).softmax(2)     # b, hw (q), hw (k)
        v = v.reshape(b, c, h * w)
        h_ = numerics.matmul(v, w_.permute(0, 2, 1)).reshape(b, c, h, w)
        return x + self.proj_out(h_)


class Middle(nn.Module):
    def __init__(self, channels: int, zq_channels: int):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels, zq_channels)
        self.attn_1 = AttnBlock(channels, zq_channels)
        self.block_2 = ResnetBlock(channels, channels, zq_channels)

    def forward(self, x, zq):
        return self.block_2(self.attn_1(self.block_1(x, zq), zq), zq)


def _run_level(level, h, zq):
    for i, block in enumerate(level.block):
        h = block(h, zq)
        if len(level.attn) > 0:
            h = level.attn[i](h, zq)
    return h


class Decoder(nn.Module):
    def __init__(self, ae: dict, resolution: int, in_ch: int):
        super().__init__()
        ch, nrb, mults = ae["channels"], ae["num_res_blocks"], ae["channel_multipliers"]
        block_in = ch * mults[-1]
        res = resolution // 2 ** (len(mults) - 1)
        self.post_quant_conv = Conv(in_ch, ae["z_channels"], 1)
        self.conv_in = Conv(ae["z_channels"], block_in, 3)
        self.mid = Middle(block_in, in_ch)
        up = []
        for i in reversed(range(len(mults))):
            blocks, attn = [], []
            for _ in range(nrb + 1):
                blocks.append(ResnetBlock(block_in, ch * mults[i], in_ch))
                block_in = ch * mults[i]
                if res in ae["attn_resolutions"]:
                    attn.append(AttnBlock(block_in, in_ch))
            level = _level(blocks, attn)
            if i != 0:
                level.upsample = Upsample(block_in)
                res *= 2
            up.insert(0, level)
        self.up = nn.ModuleList(up)
        self.norm_out = SpatialNorm(block_in, in_ch)
        self.conv_out = Conv(block_in, 3, 3)

    def forward(self, zq):
        h = self.mid(self.conv_in(self.post_quant_conv(zq)), zq)
        for level in reversed(self.up):
            h = _run_level(level, h, zq)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h, zq)))


class VQVAE(taming.VQVAE):
    """taming's encoder, quantizer, ``forward`` and ``decode_tokens``, with
    MoVQ's decoder."""

    def __init__(self, cfg: dict):
        ae = cfg["autoencoder"]
        if ae.get("norm_type") != "spatial":
            raise ValueError(f"the MoVQ reference takes norm_type spatial, not "
                             f"{ae.get('norm_type')!r}")
        super().__init__(cfg)
        self.decoder = Decoder(ae, cfg["image_size"], cfg["quantizer"]["embedding_dim"])


def tiny(cfg: dict) -> dict:
    """16^2 images, 32 channels, multipliers [1, 2] with attention at 8^2 (the
    encoder's second level, both middle blocks and the decoder's first
    level), one residual block, z_channels 4, 16 codes of 4 dims."""
    return dict(cfg, image_size=16,
                autoencoder={"layout": "taming", "norm_type": "spatial", "channels": 32,
                             "num_res_blocks": 1, "channel_multipliers": [1, 2],
                             "attn_resolutions": [8], "z_channels": 4},
                quantizer=dict(cfg["quantizer"], num_embeddings=16, embedding_dim=4))
