"""The yardstick's arithmetic: the chip's published peaks, the operations a
model needs per image, and the least time of a VQ kernel call.

Model FLOPs are counted once, from the configuration's shapes, by running
the configuration's plain reference (``reference.of``) on the meta device under
a dispatch mode that applies ``torch.utils.flop_counter``'s formulas (its
``FlopCounterMode`` hooks modules, which the R1 penalty's
``autograd.grad`` refuses): every convolution and matrix
product, forward and backward (the second-order ones of the R1 penalty
included), counted as the reference computes them. So the count never
depends on how the port implements a layer, and recomputation (the port's
remat) is not counted: the reference has none.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


def _count(fn) -> int:
    with _Counter() as counter:
        fn()
    return int(counter.total)


def train_step_flops(cfg: dict, batch: int, r1: bool) -> int:
    """FLOPs of one optimizer step of ``batch`` images (with the R1 penalty
    when ``r1``) at the GAN's epoch when the config has one."""
    from benchmark.reference.train import Run
    adv = (cfg.get("loss") or {}).get("adversarial_params")
    epoch = adv["start_epoch"] if adv else 0
    run = Run(cfg, None, seed=0, step=0, disc_step=0, spe=1, epoch=epoch,
              r1=lambda i: r1, device="meta")
    size = cfg["image_size"]
    raw = torch.zeros(batch, size, size, 3, dtype=torch.uint8, device="meta")
    return _count(lambda: run.step(raw))


def train_flops_per_image(cfg: dict, batch: int) -> float:
    """Per image, the mean over one R1 cycle (``r1_reg_every`` steps, one of
    them with R1) where the config has R1; else one step's."""
    plain = train_step_flops(cfg, batch, False)
    adv = (cfg.get("loss") or {}).get("adversarial_params")
    if not adv or adv.get("r1_reg_weight") is None:
        return plain / batch
    every = adv["r1_reg_every"]
    with_r1 = train_step_flops(cfg, batch, True)
    return ((every - 1) * plain + with_r1) / every / batch


def tokenize_flops_per_image(cfg: dict) -> float:
    """The encoder's forward and the nearest-code distances of one image."""
    from benchmark import reference
    with torch.device("meta"):
        model = reference.of(cfg).VQVAE(cfg)
    size = cfg["image_size"]
    x = torch.zeros(1, 3, size, size, device="meta")
    return float(_count(lambda: model.quantizer.codes(model.encoder(x))))


def detokenize_flops_per_image(cfg: dict) -> float:
    """The decoder's forward of one image's tokens."""
    from benchmark import reference
    arch = reference.of(cfg)
    with torch.device("meta"):
        model = arch.VQVAE(cfg)
    side = arch.latent_side(cfg)
    tokens = torch.zeros(1, side * side, dtype=torch.long, device="meta")
    return float(_count(lambda: model.decode_tokens(tokens)))


def vq_least_seconds(m: int, n: int, d: int, stats: bool) -> dict:
    """The least time of one nearest-code call on (M rows, N codes, D dims):
    the larger of its 2·M·N·D distance operations at the bf16 peak (no
    implementation of the distances at any precision is faster) and its
    bytes at the HBM peak, each input and output counted once: x and the
    codebook in fp32 and the int32 codes, and for B2 the fp32 counts and
    row sums."""
    ops = 2.0 * m * n * d
    nbytes = 4.0 * (m * d + n * d + m)
    if stats:
        nbytes += 4.0 * (n + n * d)
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S
    return {"seconds": max(t_ops, t_bytes), "ops": ops, "bytes": nbytes,
            "bound": "operations" if t_ops >= t_bytes else "bytes"}
