"""What the benchmark makes from ``--seed``: the weights of every model of a
configuration, and the images and tokens its traffic sends. Both sides of a
comparison, the port and the plain reference, are handed these.

Everything is drawn on the run's device from ``torch.Generator``s seeded by
``derive(seed, stream, index)``, in a few large calls: the weights of a
configuration take two (one uniform, one normal draw over all leaves), a
batch of images two, a batch of tokens one. The same seed gives the same
numbers on every run on one kind of device.
"""

from __future__ import annotations

import hashlib
import math

import torch
import torch.nn.functional as F


def derive(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for (``seed``, ``stream``, ``index``); any whole seed."""
    digest = hashlib.sha256(f"{int(seed)}/{stream}/{int(index)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: str, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, stream, index))


def _rule(name: str, shape, cfg: dict):
    """(draw, scale, offset) of one leaf: ``offset + scale * draw``, where
    ``draw`` is ``u`` (uniform on [-1, 1]) or ``n`` (standard normal).

    The autoencoder's kernels and biases follow torch's default conv init,
    U(+-1/sqrt(fan_in)); its GroupNorm scales lie near 1 and its shifts near
    0. The codebook lies at the latents' scale (``assumed.codebook_std``),
    as a trained one does, and the EMA buffers are a steady state of it:
    counts around the latent rows a step assigns to each code (their fixed
    point under the decay), sums of counts x rows. The
    discriminator's weights are unit normal (equalized learning rate).
    LPIPS's VGG has He-scaled kernels and positive linear heads."""
    part, rest = name.split(".", 1)
    q = cfg["quantizer"]
    if part == "model":
        if rest == "quantizer.codebook.weight":
            return "n", cfg["assumed"]["codebook_std"], 0.0
        if rest == "quantizer.ema_count":
            from benchmark import reference
            latent = reference.of(cfg).latent_side(cfg)
            mean = cfg["assumed"]["batch_images"] * latent * latent / q["num_embeddings"]
            return "u", 0.5 * mean, mean
        if rest == "quantizer.ema_weight":
            return None, 0.0, 0.0     # codebook x counts, formed after the draw
        if ".norm" in rest or rest.startswith(("encoder.norm", "decoder.norm")):
            return ("u", 0.1, 1.0) if rest.endswith("weight") else ("u", 0.1, 0.0)
        fan_in = cfg["_fan_in"][name]
        return "u", 1.0 / math.sqrt(fan_in), 0.0
    if part == "disc":
        return ("n", 1.0, 0.0) if rest.endswith("weight") else ("u", 0.1, 0.0)
    if part == "lpips":
        if rest.startswith("lin"):
            return "u", 0.5, 1.0
        if rest.endswith("weight"):
            return "n", math.sqrt(2.0 / (shape[1] * shape[2] * shape[3])), 0.0
        return "u", 0.05, 0.0
    raise ValueError(f"no weight rule for {name}")


def _fan_ins(specs: dict) -> dict:
    """Each autoencoder leaf's fan-in: a kernel's own, a bias its kernel's."""
    out = {}
    for name, shape in specs.items():
        if len(shape) == 4 and name.endswith(".weight"):
            fan = shape[1] * shape[2] * shape[3]
            out[name] = fan
            out[name[: -len("weight")] + "bias"] = fan
    return out


def make_weights(specs: dict, cfg: dict, seed: int, device) -> dict:
    """{leaf name: shape} -> {leaf name: float32 tensor on ``device``}, drawn
    from ``seed`` by ``_rule`` in two calls."""
    cfg = dict(cfg, _fan_in=_fan_ins(specs))
    names = sorted(specs)
    rules = {k: _rule(k, specs[k], cfg) for k in names}
    sizes = {k: math.prod(specs[k]) for k in names}
    counts = {"u": 0, "n": 0}
    for k in names:
        if rules[k][0] is not None:
            counts[rules[k][0]] += sizes[k]
    g = generator(seed, "weights", 0, device)
    pools = {"u": torch.rand(counts["u"], generator=g, device=device) * 2 - 1,
             "n": torch.randn(counts["n"], generator=g, device=device)}
    at = {"u": 0, "n": 0}
    out = {}
    for k in names:
        draw, scale, offset = rules[k]
        if draw is None:
            continue
        flat = pools[draw][at[draw]:at[draw] + sizes[k]]
        at[draw] += sizes[k]
        out[k] = (flat * scale + offset).reshape(specs[k])
    if "model.quantizer.ema_weight" in specs:
        out["model.quantizer.ema_weight"] = (out["model.quantizer.codebook.weight"]
                                             * out["model.quantizer.ema_count"][:, None])
    return out


def images(seed: int, index: int, batch: int, size: int, device) -> torch.Tensor:
    """(batch, size, size, 3) uint8 NHWC: smooth seeded noise, a coarse
    16th-scale field plus a finer quarter-scale one, upsampled bilinearly
    and squashed to [0, 255], so that neighbouring latents resemble each
    other and code usage is skewed, as in photographs."""
    g = generator(seed, "images", index, device)
    coarse = torch.randn(batch, 3, max(size // 16, 1), max(size // 16, 1), generator=g,
                         device=device)
    fine = torch.randn(batch, 3, max(size // 4, 1), max(size // 4, 1), generator=g,
                       device=device)
    x = (F.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False)
         + 0.3 * F.interpolate(fine, size=(size, size), mode="bilinear", align_corners=False))
    x = torch.sigmoid(1.5 * x) * 255.0
    return x.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def tokens(seed: int, index: int, batch: int, length: int, codes: int, device) -> torch.Tensor:
    """(batch, length) int64 tokens drawn uniformly over ``codes``."""
    g = generator(seed, "tokens", index, device)
    return torch.randint(0, codes, (batch, length), generator=g, device=device)
