"""The plain reference of the VQ-VAE: encoder, decoder, the EMA and gumbel
quantizers, the training augmentation and the schedules, in plain PyTorch
and float32 (convolutions and products through ``numerics``).

It follows the published model (SerezD/vqvae-vqgan-pytorch-lightning,
``vqvae/modules``) as the port states it, and keeps the port's parameter
names, so that one set of weights made by the benchmark loads into both.
Departures from the published code that the port makes, and that this
reference therefore makes too: GroupNorm's variance is the unbiased one
(``/(n-1)``) with eps 1e-6; the EMA update normalizes the Laplace smoothing
by the image count; the augmentation's crop-resize samples the whole image
with tent weights (``jax.image.scale_and_translate``'s linear method).

It is the reference of every configuration that names none, and gives the
interface of ``reference/__init__.py``; the augmentation and the schedules
serve the training reference of every architecture.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import numerics


class GroupNorm(nn.Module):
    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(1, channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(1, channels, 1, 1))

    def forward(self, x):
        b, c, h, w = x.shape
        xg = x.float().reshape(b, self.groups, -1)
        mean = xg.mean(-1, keepdim=True)
        var = (xg - mean).square().sum(-1, keepdim=True) / (xg.shape[-1] - 1)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(b, c, h, w)
        return y * self.weight + self.bias


class Conv(nn.Module):
    """A 'same' convolution; its kernel takes weight decay."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        k = self.weight.shape[-1]
        return numerics.conv2d(x, self.weight, self.bias, padding=k // 2)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GroupNorm(cin)
        self.conv1 = Conv(cin, cout, 3, False)
        self.norm2 = GroupNorm(cout)
        self.conv2 = Conv(cout, cout, 3, False)
        self.conv_shortcut = Conv(cin, cout, 1, False) if cin != cout else None

    def forward(self, x):
        r = self.conv1(F.silu(self.norm1(x)))
        r = self.conv2(F.silu(self.norm2(r)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + r


class Downsample(nn.Module):
    def forward(self, x):
        return F.avg_pool2d(x, 2)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv(ch, ch, 3, True)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Encoder(nn.Module):
    def __init__(self, ch: int, nrb: int, mults, out_ch: int):
        super().__init__()
        self.conv_in = Conv(3, ch, 3, False)
        blocks, c = [], ch
        for m in mults:
            for _ in range(nrb):
                blocks.append(ResBlock(c, ch * m))
                c = ch * m
            blocks.append(Downsample())
        self.blocks = nn.ModuleList(blocks)
        self.final_residual = nn.ModuleList([ResBlock(c, c) for _ in range(nrb)])
        self.norm = GroupNorm(c)
        self.conv_out = Conv(c, out_ch, 1, True)

    def forward(self, x):
        x = self.conv_in(x)
        for block in [*self.blocks, *self.final_residual]:
            x = block(x)
        return self.conv_out(F.silu(self.norm(x)))


class Decoder(nn.Module):
    def __init__(self, ch: int, nrb: int, mults, in_ch: int):
        super().__init__()
        c = ch * mults[-1]
        self.conv_in = Conv(in_ch, c, 3, True)
        self.initial_residual = nn.ModuleList([ResBlock(c, c) for _ in range(nrb)])
        blocks = []
        for i in reversed(range(len(mults))):
            c_out = ch * mults[i - 1] if i > 0 else ch
            for _ in range(nrb):
                blocks.append(ResBlock(c, c_out))
                c = c_out
            blocks.append(Upsample(c))
        self.blocks = nn.ModuleList(blocks)
        self.norm = GroupNorm(c)
        self.conv_out = Conv(c, 3, 3, True)

    def forward(self, x):
        x = self.conv_in(x)
        for block in [*self.initial_residual, *self.blocks]:
            x = block(x)
        return torch.tanh(self.conv_out(F.silu(self.norm(x))))


def _flatten(z):
    b, d, h, w = z.shape
    return z.permute(0, 2, 3, 1).reshape(b * h * w, d), (b, h, w, d)


def _unflatten(flat, shape):
    b, h, w, d = shape
    return flat.reshape(b, h, w, d).permute(0, 3, 1, 2)


def scores(flat_x, codebook):
    """|c|^2 - 2 x.c per (row, code): the argmin is the nearest code."""
    cb = codebook.float()
    return (cb * cb).sum(1)[None] - 2 * numerics.matmul(flat_x.float(), cb.T)


class EMAQuantizer(nn.Module):
    def __init__(self, n: int, d: int, commitment: float, decay: float, eps: float):
        super().__init__()
        self.n, self.commitment, self.decay, self.eps = n, commitment, decay, eps
        self.codebook = nn.Module()
        self.codebook.register_buffer("weight", torch.zeros(n, d))
        self.register_buffer("ema_count", torch.zeros(n))
        self.register_buffer("ema_weight", torch.zeros(n, d))

    def codes(self, z):
        flat, (b, h, w, _) = _flatten(z)
        return scores(flat, self.codebook.weight).argmin(1).reshape(b, h * w)

    def forward(self, z, train: bool, **_):
        codebook = self.codebook.weight
        flat, shape = _flatten(z)
        codes = scores(flat.detach(), codebook).argmin(1)
        quantized = codebook[codes]
        if train:
            with torch.no_grad():
                counts = torch.zeros_like(self.ema_count).index_add_(
                    0, codes, torch.ones_like(codes, dtype=torch.float32))
                dw = torch.zeros_like(self.ema_weight).index_add_(0, codes, flat.float())
                b = float(shape[0])
                count = self.ema_count * self.decay + (1 - self.decay) * counts
                count = (count + self.eps) / (b + self.n * self.eps) * b
                self.ema_weight.mul_(self.decay).add_((1 - self.decay) * dw)
                self.ema_count.copy_(count)
                codebook.copy_(self.ema_weight / count[:, None])
        loss = self.commitment * (quantized - flat).square().mean()
        quantized = flat + (quantized - flat).detach()
        return _unflatten(quantized, shape), codes.reshape(shape[0], -1), loss


def gumbel_noise(shape, device, generator):
    """-log(E), E ~ Exp(1): the draw of ``F.gumbel_softmax``."""
    return -torch.empty(shape, device=device).exponential_(generator=generator).log()


class GumbelQuantizer(nn.Module):
    def __init__(self, n: int, d: int):
        super().__init__()
        self.n = n
        self.codebook = nn.Module()
        self.codebook.weight = nn.Parameter(torch.zeros(n, d))
        self.x_to_logits = Conv(n, n, 1, True)

    def forward(self, z, train: bool, temp: float, kl_cost: float, generator=None):
        flat, (b, h, w, n) = _flatten(z)
        wt = self.x_to_logits.weight[:, :, 0, 0]
        logits = numerics.matmul(flat.float(), wt.T) + self.x_to_logits.bias.float()
        g = gumbel_noise(logits.shape, logits.device, generator)
        soft = ((logits + g) / temp).softmax(-1)   # training's soft one-hot
        quantized = numerics.matmul(soft, self.codebook.weight)
        qy = logits.softmax(-1)
        kl = kl_cost * (qy * torch.log(qy * n + 1e-10)).sum(-1).mean()
        codes = soft.detach().argmax(-1).reshape(b, h * w)
        return _unflatten(quantized, (b, h, w, -1)), codes, kl


class VQVAE(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ae, q = cfg["autoencoder"], cfg["quantizer"]
        n, d, p = q["num_embeddings"], q["embedding_dim"], q["params"]
        self.kind = q["type"]
        if self.kind == "ema":
            self.quantizer = EMAQuantizer(n, d, p["commitment_cost"], p["decay"], p["epsilon"])
        elif self.kind == "gumbel" and not p.get("straight_through"):
            self.quantizer = GumbelQuantizer(n, d)
        else:
            raise ValueError(f"the reference has no {self.kind!r} quantizer with {p}")
        ch, nrb, mults = ae["channels"], ae["num_res_blocks"], ae["channel_multipliers"]
        self.encoder = Encoder(ch, nrb, mults, n if self.kind == "gumbel" else d)
        self.decoder = Decoder(ch, nrb, mults, d)

    def forward(self, x, train: bool = False, **quantizer_args):
        """Normalized NHWC images -> (NHWC reconstruction, quantizer loss, codes)."""
        z = self.encoder(x.permute(0, 3, 1, 2))
        quantized, codes, loss = self.quantizer(z, train, **quantizer_args)
        return self.decoder(quantized).permute(0, 2, 3, 1), loss, codes

    def decode_tokens(self, tokens):
        """(B, S) tokens -> NHWC images in [0, 1]."""
        b, s = tokens.shape
        hw = int(round(s ** 0.5))
        q = self.quantizer.codebook.weight[tokens.reshape(-1).long()]
        q = q.reshape(b, hw, hw, -1).permute(0, 3, 1, 2)
        return (self.decoder(q) * 0.5 + 0.5).clamp(0, 1).permute(0, 2, 3, 1)


def latent_side(cfg: dict) -> int:
    """Every level of the encoder halves the image."""
    return cfg["image_size"] // 2 ** len(cfg["autoencoder"]["channel_multipliers"])


def tiny(cfg: dict) -> dict:
    """16^2 images, 32 channels, multipliers [1, 2], 16 codes of 8 dims."""
    return dict(cfg, image_size=16,
                autoencoder={"channels": 32, "num_res_blocks": 1, "channel_multipliers": [1, 2]},
                quantizer=dict(cfg["quantizer"], num_embeddings=16, embedding_dim=8))


def decay_names(model: nn.Module, prefix: str = "") -> set:
    """Names of the parameters that take weight decay: convolution kernels."""
    return {f"{prefix}{name}.weight" for name, m in model.named_modules() if isinstance(m, Conv)}


# the training augmentation and the preprocessing

def normalize(images_u8):
    return images_u8.float() / 255.0 * 2.0 - 1.0


def _tent_weights(in_size, out_size, crop, start):
    inv = (crop / out_size)[:, None]
    i = torch.arange(out_size, dtype=torch.float32, device=crop.device)
    sample = (i[None] + 0.5) * inv - 0.5 + start[:, None]
    j = torch.arange(in_size, dtype=torch.float32, device=crop.device)
    wts = torch.clamp(1.0 - (sample[:, :, None] - j).abs(), min=0.0)
    total = wts.sum(2, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    wts = torch.where(total.abs() > eps, wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, :, None], wts, 0.0)


def augment(images_u8, generator, out_size: int):
    """RandomResizedCrop(scale 0.7-1, ratio 1) + horizontal flip, drawn from
    ``generator`` in the port's order (area, y0, x0, flip), normalized."""
    x = images_u8.float() / 255.0
    b, h, w, _ = x.shape

    def uniform():
        return torch.rand(b, generator=generator, device=generator.device).to(x.device)

    area = 0.7 + 0.3 * uniform()
    crop = torch.floor(torch.sqrt(area * h * w)).clamp(1, min(h, w))
    y0 = torch.floor(uniform() * (h - crop))
    x0 = torch.floor(uniform() * (w - crop))
    wy = _tent_weights(h, out_size, crop, y0)
    wx = _tent_weights(w, out_size, crop, x0)
    out = torch.einsum("biy,byxc,bjx->bijc", wy, x, wx)
    flip = uniform() < 0.5
    out = torch.where(flip[:, None, None, None], out.flip(2), out)
    return torch.clamp(out, 0.0, 1.0) * 2.0 - 1.0


def _cosine(start, stop, v0, v1):
    def fn(step):
        t = min(max((float(step) - start) / max(stop - start, 1e-9), 0.0), 1.0)
        return v1 + (v0 - v1) * 0.5 * (1.0 + math.cos(math.pi * t))
    return fn


def _linear(start, stop, v0, v1):
    def fn(step):
        t = min(max((float(step) - start) / max(stop - start, 1e-9), 0.0), 1.0)
        return v0 + (v1 - v0) * t
    return fn


def lr_schedule(lr: float, spe: int, warmup: Optional[float], decay: Optional[float]):
    """The published schedule (model.py on_train_start): warm-up and decay ->
    linear 0 -> lr, then cosine lr -> lr/2; one of them alone; else constant."""
    if warmup is not None and decay is not None:
        warm = _linear(0.0, warmup * spe, 0.0, lr)
        cos = _cosine(warmup * spe, decay * spe, lr, lr / 2)
        return lambda s: warm(s) if s < warmup * spe else cos(s)
    if warmup is not None:
        return _linear(0.0, warmup * spe, 1e-20, lr)
    if decay is not None:
        return _cosine(0.0, decay * spe, lr, lr / 2)
    return lambda s: lr


def gumbel_schedules(p: dict, spe: int):
    """(temperature, KL cost) as functions of the step (model.py:189-200)."""
    kl = (_cosine(0.0, int(p["kl_warmup_epochs"] * spe), 0.0, p["kl_cost"])
          if p.get("kl_warmup_epochs") is not None else (lambda s: p["kl_cost"]))
    if p.get("temp_decay_epochs") is not None and p.get("temp_final") is not None:
        temp = _cosine(0.0, int(p["temp_decay_epochs"] * spe), p["temp"], p["temp_final"])
    else:
        temp = lambda s: p["temp"]   # noqa: E731
    return temp, kl
