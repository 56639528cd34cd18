"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit (nvcc). It builds the port's kernels from ``vqvae_tpu_torch/csrc``
into ``vqvae_tpu_torch/_build/`` (one nvcc per source, all at once), then
runs these phases; a failure in any of them ends the script with a non-zero
exit and no result line:

1. device: card name and power limit (nvidia-smi); TF32 off for matmuls and
   convolutions, so that fp32 means fp32;
2. build: the time nvcc takes, and ptxas's registers, shared memory and
   spills of each kernel (B1, B2, and B3 / B4 by element type and columns
   per lane: B3 8 output columns on the vector path, B4 4 dYs columns, 1 on
   their scalar paths);
3. B1 vs plain: the nearest-code kernel against ``nearest_codes_reference``
   at the tokenizer's shapes and at ragged ones (an odd D, a latent buffer
   that is not 16-byte aligned); a duplicated codebook row whose copies fall
   in different code ranges of the scan (the first index wins), a NaN
   latent row, a NaN codebook row (every row takes it, as ``torch.argmin``
   does) and +-inf latents, each equal to the plain version; a second launch
   bit-identical;
4. tokenizer slice: the tokenizer API (``get_tokens``, ``reconstruct``,
   ``reconstruct_from_tokens``) at full width on
   ``example_confs/standard_vqvae.yaml`` with seeded random weights, at
   batch 1, 8 and 32, counting kernel launches;
5. B2 vs plain: the nearest-code-statistics kernel against
   ``nearest_codes_stats_reference`` at the EMA training shape and at
   ragged ones: codes by B1's near-tie rule, counts exact, sums within
   ``1e-6 (1 + count) max|x|``, unused codes exactly 0, two launches
   bit-identical;
6. training slice: ``train.loop.Trainer`` at full width on
   ``example_confs/ema_vqvae.yaml`` with seeded random weights, one fixed
   batch of 32: 8 steps in fp32, then 8 in bf16 compute, counting launches
   (16 of B2, none of B1); the EMA buffers after the first fp32 step held
   against a plain recomputation from that step's encoder latents; then
   ``eval_step`` and ``get_tokens`` on the trained model (B1);
7. B3 and B4 vs plain: the discriminator's fused-backward kernels against
   ``blur_t_gate_reference`` / ``skip_fanout_bwd_reference`` at every block
   shape of the 256^2 D at batch 32 and at ragged shapes, fp32 and bf16:
   fp32 within ``FP32_SHARE`` of the sum of the absolute terms, bf16 within
   one bf16 ulp of the fp32 value, db0 within ``DB_SHARE`` of a float64
   sum, two launches bit-identical; the block shapes also at the CLI's GAN
   micro-batch of 16 (phase 10 (c));
8. GAN slice: ``Trainer(gumbel_vqgan.yaml, fused_dbwd=True,
   fused_skip=True)`` at full width (the whole D, LPIPS-VGG with seeded
   random weights unless the converted .npz is present), one fixed batch of
   32, ``epoch=start_epoch`` so the GAN is active: 4 bf16 steps then 4 fp32
   steps (host step 0 is an R1 step), every metric finite, R1 > 0 on the R1
   step only, B3 and B4 launched 12 times on the R1 step and 18 on the
   others, B1 and B2 never; then one non-R1 fp32 step's autoencoder and D
   gradients, fused against plain, within ``GRAD_SHARE`` of each tensor's
   largest entry (or of 1e-3 of the module's, if that is larger);
   ``eval_step`` with the GAN active; peak memory;
9. times: CUDA events, warm-up, median of 5 windows: B1 (also at the
   batch-1 shape) and B2 against their plain versions and a PyTorch
   composition, beside their 3xTF32 and FFMA bounds, the tokenizer calls, the
   train step; B3 and B4 at every D block shape in fp32 and bf16 against
   theirs (and the kernels' device time), with each shape's launches per
   GAN step and, per step, the sum of launches x (time - bound); the GAN
   step, R1 and not, fused and plain, in bf16 and fp32 (3 windows after a
   warm-up for a non-R1 step, 1 window for an R1 step);
10. cli: the port's train CLI (``vqvae_tpu_torch.cli.train.main``) in
   process, bf16 (its default), torch's default TF32 settings, on seeded
   uint8 256^2 images written with ``write_packed`` (``--dataloader
   packed``, 1280 train and 40 validation images); the packed reader and
   the LR twin must be native (g++ builds them). (a) ``ema_vqvae.yaml`` at
   ``grad_accum_steps 8`` with reinit every epoch: one epoch, then a resume
   from ``last/`` to a second; B2 launched exactly 8 times per optimizer
   step, B1 by validation, every logged value finite, ``epoch_0000/``,
   ``epoch_0001/`` and ``last/`` written, the resumed steps continuing the
   first run's, and the epoch-1 reinit turning each dead row into a used
   row's copy with ``codebook == ema_weight / ema_count`` (rtol 1e-6). (b)
   ``gumbel_vqgan_1chip.yaml`` unchanged (cumulative_bs 256 = 8 x 32,
   pre-GAN): one epoch of 5 steps; each step's time on the stream by CUDA
   events (no synchronisation between steps, so the loop's overlap of
   loader and copies stays), images/s, the loop's own logged
   ``train/images_per_sec``, and the peak memory of training and of
   validation. (c) that config with the GAN from
   epoch 0, ``use_adaptive: true``, cumulative_bs 32 at ``grad_accum_steps
   2`` and ``VQVAE_TPU_FUSED_DBWD=1 VQVAE_TPU_FUSED_SKIP=1``: two steps (R1,
   then not) on 64 images; B3 and B4 launched, ``g_weight`` finite and > 0,
   R1 > 0 on step 0 only; then one non-R1 fp32 step of that config (TF32
   off) on 32 of its images, fused against plain: every gradient and the
   adaptive ``g_weight`` within ``GRAD_SHARE``.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a visible CUDA device it exits
non-zero before doing anything.
"""

from __future__ import annotations

import collections
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import ExitStack, contextmanager
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import yaml

from vqvae_tpu_torch import load_config, profile_tokenizer
from vqvae_tpu_torch.cli import train as cli_train
from vqvae_tpu_torch.data.packed import PackedDataset, write_packed
from vqvae_tpu_torch.models.preprocess import preprocess_batch
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.ops import _build, fused_dbwd, fused_dbwd_cuda, vq_cuda
from vqvae_tpu_torch.ops.upfirdn2d import upfirdn2d
from vqvae_tpu_torch.ops.vq import (code_mismatches, nearest_codes, nearest_codes_reference,
                                    nearest_codes_stats, nearest_codes_stats_reference)
from vqvae_tpu_torch.train import loop
from vqvae_tpu_torch.train.loop import Trainer
from vqvae_tpu_torch.train.native_schedulers import build_native_lr_scheduler

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "example_confs" / "standard_vqvae.yaml"
TRAIN_CONFIG = ROOT / "example_confs" / "ema_vqvae.yaml"
GAN_CONFIG = ROOT / "example_confs" / "gumbel_vqgan.yaml"
RECIPE_CONFIG = ROOT / "example_confs" / "gumbel_vqgan_1chip.yaml"
SEED = 0
KERNEL_SHAPES = [(8192, 1024, 256), (256, 1024, 256), (1000, 37, 8), (4097, 1024, 256),
                 (1000, 300, 37)]
B1_TIMED = [(8192, 1024, 256), (8192, 4096, 256), (256, 1024, 256)]
SPLIT_SWEEP = {(256, 1024, 256): (8, 32, 66, 132), (8192, 1024, 256): (2, 4, 8),
               (8192, 4096, 256): (2, 4)}
STATS_SHAPES = [(8192, 4096, 256), (256, 4096, 256), (1000, 37, 8), (4097, 1024, 256)]
MISMATCH_SHARE = 1e-4       # at most 0.01% of rows may differ, each a near-tie
RECON_ATOL = 1e-4           # reconstruct_from_tokens(get_tokens(x)) vs reconstruct(x)
DW_RTOL = 1e-6              # |dw - dw_plain| <= DW_RTOL (1 + count) max|x|, per code
EMA_RTOL, EMA_ATOL = 1e-5, 1e-6   # EMA buffers after a step vs the plain recomputation
BATCHES = (1, 8, 32)
TIMED_BATCH = 32
TRAIN_BATCH = 32
TRAIN_STEPS = 8             # per precision
STEPS_PER_EPOCH = 1000      # the LR schedule's epoch; the smoke run stays in epoch 0
# B3 / B4: (C, H=W) of the 256^2 D's blocks, at DBWD_BATCH; ragged (B, C, H, W)
DBWD_BLOCKS = [(128, 256), (256, 128), (512, 64), (512, 32), (512, 16), (512, 8)]
DBWD_RAGGED = [(1, 3, 7, 9), (1, 37, 33, 17), (1, 130, 15, 31)]
DBWD_BATCH = 32
FP32_SHARE = 2e-6           # fp32: |kernel - plain| <= FP32_SHARE * sum of |terms|
BF16_ULP = 2.0 ** -7        # bf16: within one bf16 ulp of the fp32 value
DB_SHARE = 1e-5             # |db0 - float64 sum| <= DB_SHARE * sum of |dp0| per channel
GAN_BATCH = 32
GAN_STEPS = 4               # per precision
GRAD_SHARE = 1e-4           # fused vs plain gradients, share of each tensor's largest entry
CLI_TRAIN_IMAGES = 1280     # 5 optimizer steps of cumulative_bs 256
CLI_VAL_IMAGES = 40
CLI_ACCUM = 8               # leg (a): ema_vqvae.yaml's 256 as 8 micro-batches of 32
CLI_GAN_BATCH = 32          # leg (c): CLI_GAN_ACCUM micro-batches of 16
CLI_GAN_ACCUM = 2
# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): fp32 on the
# CUDA cores, TF32 on the tensor cores (dense), and device memory
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
MEM_BYTES_PER_S = 3.35e12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps: int, windows: int = 5, warmup: int = 2) -> float:
    """Median over ``windows`` of the mean CUDA-event time of ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}, "
          f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def bound(flops: float, nbytes: float):
    """(least ms the card could take, "operations" or "bytes")."""
    t_ops = flops / FP32_FLOPS * 1e3
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_3xtf32(m: int, n: int, d: int, nbytes: float, fp32_flops: float = 0.0):
    """(least ms, "operations" or "bytes", FFMA-only ms) of a nearest-code
    scan: 3 TF32 passes x 2*m*n*d on the tensor cores (plus ``fp32_flops`` on
    the CUDA cores) against the bytes; the FFMA-only time is the same product
    in fp32 FMAs, the bound of the scan before the tensor cores."""
    t_ops = (3 * 2 * m * n * d / TF32_FLOPS + fp32_flops / FP32_FLOPS) * 1e3
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ffma = (2 * m * n * d + fp32_flops) / FP32_FLOPS * 1e3
    return (t_ops, "operations", t_ffma) if t_ops >= t_bytes else (t_bytes, "bytes", t_ffma)


def ptxas_summary(report: str) -> list[str]:
    """One line per kernel of nvcc's ``-Xptxas -v`` output: registers, spills
    and shared memory."""
    lines, name, spill = [], None, ""
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = re.search(r"(nearest_codes[a-z_]*?_kernel)(ILb([01])E)?", entry.group(1))
            dbwd = re.search(r"(blur_t_gate_kernel|skip_fanout_bwd_kernel)I(f|13__nv_bfloat16)"
                             r"Li(\d+)E", entry.group(1))
            if dbwd:
                dtype = "float" if dbwd.group(2) == "f" else "bf16"
                name = f"{dbwd.group(1)}<{dtype}, {dbwd.group(3)}>"
            elif kernel:
                name = kernel.group(1) + (f"<{'true' if kernel.group(3) == '1' else 'false'}>"
                                          if kernel.group(2) else "")
            else:
                name = entry.group(1)
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            used = line.split(":", 1)[1].strip()
            lines.append(f"{name}: {used}; {spill}")
            name, spill = None, ""
    return lines


def phase_build() -> None:
    names = ("nearest_codes", "nearest_codes_stats", "fused_dbwd")
    fresh = [n for n in names if not _build.library_path(n).exists()]
    t0 = time.perf_counter()
    reports = _build.build(names)
    vq_cuda.library()
    vq_cuda.stats_library()
    fused_dbwd_cuda.library()
    print(f"build: {', '.join(f'{n}.cu' for n in names)}: {len(fresh)} built, in parallel, "
          f"in {time.perf_counter() - t0:.2f} s -> "
          f"{', '.join(str(_build.library_path(n).relative_to(ROOT)) for n in names)}")
    for lib in ("nearest_codes", "nearest_codes_stats", "fused_dbwd"):
        for line in ptxas_summary(reports.get(lib, "")):
            print(f"ptxas {lib}.cu: {line}")


def _agree(x, cb, got, want, what: str) -> float:
    n_mis, n_bad, gap = code_mismatches(x, cb, got, want)
    m = x.shape[0]
    print(f"{what}: {n_mis} of {m} rows differ from the plain version "
          f"(limit {MISMATCH_SHARE * m:.2f}), {n_bad} outside the near-tie rule, "
          f"max score gap {gap:.3e}")
    check(n_bad == 0 and n_mis <= MISMATCH_SHARE * m, what)
    return gap


def phase_kernel(device) -> float:
    gen = torch.Generator(device=device).manual_seed(SEED)
    max_gap = 0.0
    for m, n, d in KERNEL_SHAPES:
        cb = torch.randn(n, d, device=device, generator=gen)
        near = cb[torch.randint(0, n, (m,), device=device, generator=gen)]
        for kind, x in (
                ("gaussian", torch.randn(m, d, device=device, generator=gen)),
                ("near codebook rows", near + 0.05 * torch.randn(m, d, device=device,
                                                                  generator=gen))):
            got = vq_cuda.nearest_codes_cuda(x, cb)
            want = nearest_codes_reference(x, cb)
            torch.cuda.synchronize()
            max_gap = max(max_gap, _agree(x, cb, got, want,
                                          f"kernel vs plain ({m},{n},{d}) {kind}"))
            if (m, n, d) == KERNEL_SHAPES[0]:
                check(torch.equal(got, vq_cuda.nearest_codes_cuda(x, cb)),
                      f"kernel ({m},{n},{d}) {kind}: bit-identical rerun")
    # the 4-byte copy path: latents that are not 16-byte aligned
    m, n, d = KERNEL_SHAPES[0]
    cb = torch.randn(n, d, device=device, generator=gen)
    x = torch.randn(m * d + 1, device=device, generator=gen)[1:].view(m, d)
    max_gap = max(max_gap, _agree(x, cb, vq_cuda.nearest_codes_cuda(x, cb),
                                  nearest_codes_reference(x, cb),
                                  f"kernel vs plain ({m},{n},{d}) latents 4 bytes off alignment"))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for m, n, d, i, j in ((512, 1024, 256, 300, 700), (8192, 1024, 256, 100, 1000),
                          (256, 1024, 256, 3, 500)):
        # a duplicated codebook row ties exactly, its copies in different code
        # ranges of the scan: the first index wins; a NaN latent row maps to
        # code 0 as torch.argmin does
        ranges = vq_cuda.code_ranges(n, vq_cuda.scan_splits(m, n, sms))
        ri, rj = (next(r for r, (lo, hi) in enumerate(ranges) if lo <= c < hi) for c in (i, j))
        check(ri != rj, f"codes {i} and {j} fall in different code ranges at ({m},{n},{d})")
        cb = torch.randn(n, d, device=device, generator=gen)
        cb[j] = cb[i]
        x = torch.randn(m, d, device=device, generator=gen)
        x[:m // 2] = cb[i]
        x[m // 2 + 7, 5] = float("nan")
        got = vq_cuda.nearest_codes_cuda(x, cb)
        want = nearest_codes_reference(x, cb)
        check(bool((got[:m // 2] == i).all()), f"({m},{n},{d}) duplicated row: the first index wins")
        check(int(got[m // 2 + 7]) == 0, f"({m},{n},{d}) NaN row -> code 0")
        max_gap = max(max_gap, _agree(x, cb, got, want, f"kernel vs plain ({m},{n},{d}) with "
                                      f"codebook row {j} (code range {rj} of {len(ranges)}) = "
                                      f"row {i} (range {ri}) and a NaN latent row"))
        print(f"kernel vs plain ({m},{n},{d}): the duplicated row -> first index {i} on "
              f"{m // 2} of {m // 2} rows; NaN row -> code 0")
    # a NaN in a codebook row: every row takes that code; +-inf latents
    m, n, d = 512, 1024, 256
    cb = torch.randn(n, d, device=device, generator=gen)
    x = torch.randn(m, d, device=device, generator=gen)
    x[5, 7] = float("inf")
    x[6, 9] = float("-inf")
    x[7, :3] = float("inf")
    got = vq_cuda.nearest_codes_cuda(x, cb)
    want = nearest_codes_reference(x, cb)
    check(torch.equal(got, want), "+-inf latents as the plain version")
    x = torch.randn(m, d, device=device, generator=gen)
    cb[611, 17] = float("nan")
    got_nan = vq_cuda.nearest_codes_cuda(x, cb)
    check(bool((got_nan == 611).all()) and torch.equal(got_nan, nearest_codes_reference(x, cb)),
          "a NaN codebook row takes every row, as the plain version")
    print(f"kernel vs plain ({m},{n},{d}): +-inf latents -> codes {got[5:8].tolist()} "
          f"(plain {want[5:8].tolist()}); NaN in codebook row 611 -> code 611 on all {m} rows")
    return max_gap


def phase_slice(cfg, device):
    model = VQVAE.from_config(cfg, device=device,
                              generator=torch.Generator().manual_seed(SEED))
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    size = cfg.image_size
    batches = {b: torch.rand(b, size, size, 3, device=device, generator=gen) for b in BATCHES}

    nearest_codes.launches = 0
    nearest_codes_stats.launches = 0
    outputs = {}
    for b, images in batches.items():
        tokens = model.get_tokens(images)
        recon = model.reconstruct(images)
        outputs[b] = (tokens, recon, model.reconstruct_from_tokens(tokens))
    torch.cuda.synchronize()
    launches = nearest_codes.launches
    print(f"slice: {2 * len(BATCHES)} tokenizer calls launched the nearest_codes kernel "
          f"{launches} times, nearest_codes_stats {nearest_codes_stats.launches} times")
    # one launch per get_tokens and one per reconstruct, at every batch size
    check(launches == 2 * len(BATCHES) and nearest_codes_stats.launches == 0,
          f"the tokenizer path launched the nearest_codes kernel {2 * len(BATCHES)} times "
          "and nearest_codes_stats never")

    n_codes = cfg.quantizer.num_embeddings
    seq = cfg.latent_size ** 2
    max_gap = 0.0
    for b, (tokens, recon, from_tokens) in outputs.items():
        check(tokens.shape == (b, seq) and tokens.dtype == torch.int32, f"tokens shape b={b}")
        check(bool(((tokens >= 0) & (tokens < n_codes)).all()), f"tokens in range b={b}")
        with torch.inference_mode():
            z = model.encode(preprocess_batch(batches[b]))
            flat = z.reshape(-1, z.shape[-1])
            cb = model.quantizer.codebook.weight
            max_gap = max(max_gap, _agree(flat, cb, tokens.reshape(-1),
                                          nearest_codes_reference(flat, cb),
                                          f"slice b={b}: get_tokens vs plain on the latents "
                                          f"({near_ties(flat.contiguous(), cb.contiguous())} "
                                          "near ties rescored)"))
        check(recon.shape == (b, size, size, 3), f"reconstruct shape b={b}")
        check(bool(torch.isfinite(recon).all()) and float(recon.min()) >= 0
              and float(recon.max()) <= 1, f"reconstruct finite in [0,1] b={b}")
        err = float((from_tokens - recon).abs().max())
        print(f"slice b={b}: tokens {tuple(tokens.shape)} int32, {tokens.unique().numel()} "
              f"distinct codes; reconstruct {tuple(recon.shape)} finite in [0,1]; "
              f"|reconstruct_from_tokens(get_tokens(x)) - reconstruct(x)| max {err:.3e} "
              f"(atol {RECON_ATOL})")
        check(err <= RECON_ATOL, f"reconstruct_from_tokens(get_tokens(x)) vs reconstruct(x) b={b}")
    return model, launches, max_gap


def _stats_agree(x, cb, got, what: str) -> float:
    """B2's outputs against the plain version on the same inputs; returns the
    largest |dw - dw_plain|."""
    codes, counts, dw = got
    n = cb.shape[0]
    _agree(x, cb, codes, nearest_codes_reference(x, cb), f"{what}: codes")
    check(torch.equal(codes, vq_cuda.nearest_codes_cuda(x, cb)), f"{what}: B2 codes == B1 codes")
    check(torch.equal(counts, torch.bincount(codes.long(), minlength=n).float()),
          f"{what}: counts == bincount of the codes")
    # the plain sums of the kernel's own codes: a near-tie flip is not a sum error
    onehot = torch.nn.functional.one_hot(codes.long(), n).float()
    err = (dw - onehot.T @ x).abs()
    limit = DW_RTOL * (1 + counts[:, None]) * x.abs().max()
    unused = counts == 0
    check(bool((err <= limit).all()), f"{what}: dw within {DW_RTOL} (1 + count) max|x|")
    check(bool((dw[unused] == 0).all()), f"{what}: unused codes have dw exactly 0")
    again = vq_cuda.nearest_codes_stats_cuda(x, cb)
    check(all(torch.equal(a, b) for a, b in zip(got, again)), f"{what}: bit-identical rerun")
    max_err = float(err.max())
    print(f"{what}: counts == bincount, {int(unused.sum())} of {n} codes unused (dw 0), "
          f"max |dw - plain| {max_err:.3e} (worst share of limit "
          f"{float((err / limit).max()):.3f}), second launch bit-identical")
    return max_err


def phase_stats_kernel(device) -> float:
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    max_err = 0.0
    for m, n, d in STATS_SHAPES:
        cb = torch.randn(n, d, device=device, generator=gen)
        near = cb[torch.randint(0, n, (m,), device=device, generator=gen)]
        for kind, x in (
                ("gaussian", torch.randn(m, d, device=device, generator=gen)),
                ("near codebook rows", near + 0.05 * torch.randn(m, d, device=device,
                                                                  generator=gen))):
            got = vq_cuda.nearest_codes_stats_cuda(x, cb)
            torch.cuda.synchronize()
            max_err = max(max_err, _stats_agree(x, cb, got, f"B2 vs plain ({m},{n},{d}) {kind}"))
    return max_err


class _FirstQuantizerCall:
    """Forward hooks on the quantizer: the first train=True call's latents, the
    EMA buffers before it, and the codes it picked."""

    def __init__(self, quantizer):
        self.z = self.before = self.codes = None
        self._handles = [
            quantizer.register_forward_pre_hook(self._pre, with_kwargs=True),
            quantizer.register_forward_hook(self._post, with_kwargs=True)]

    def _pre(self, module, args, kwargs):
        if self.z is None and kwargs.get("train"):
            self.z = args[0].detach().clone()
            self.before = {k: v.clone() for k, v in module.state_dict().items()}

    def _post(self, module, args, kwargs, out):
        if self.codes is None and kwargs.get("train"):
            self.codes = out[1].reshape(-1).clone()

    def remove(self):
        for h in self._handles:
            h.remove()


def _check_ema_update(quantizer, first: "_FirstQuantizerCall") -> None:
    """EMA buffers after the first step against the EMA formula applied to
    the plain statistics of that step's latents."""
    z = first.z
    b, d = z.shape[0], z.shape[1]
    flat = z.permute(0, 2, 3, 1).reshape(-1, d)
    before = first.before
    cb0 = before["codebook.weight"]
    decay, eps, n = quantizer.decay, quantizer.epsilon, quantizer.num_embeddings
    codes, counts, dw = nearest_codes_stats_reference(flat, cb0)
    _agree(flat, cb0, first.codes, codes, "train slice: first step's codes vs plain")
    n_mis = int((first.codes != codes).sum())
    if n_mis:  # near-ties only (checked above): hold the sums to the kernel's codes
        onehot = torch.nn.functional.one_hot(first.codes.long(), n).float()
        counts, dw = onehot.sum(0), onehot.T @ flat
    ema_count = before["ema_count"] * decay + (1 - decay) * counts
    ema_count = (ema_count + eps) / (b + n * eps) * b
    ema_weight = before["ema_weight"] * decay + (1 - decay) * dw
    want = {"ema_count": ema_count, "ema_weight": ema_weight,
            "codebook.weight": ema_weight / ema_count[:, None]}
    shares = {}
    for k, v in quantizer.state_dict().items():
        shares[k] = float(((v - want[k]).abs() / (EMA_ATOL + EMA_RTOL * want[k].abs())).max())
        check(shares[k] <= 1, f"train slice: {k} after the first step vs the plain EMA update")
    print(f"train slice: EMA buffers after the first fp32 step equal the plain update of that "
          f"step's latents (rtol {EMA_RTOL}, atol {EMA_ATOL}; worst share of the tolerance "
          f"{', '.join(f'{k} {v:.3f}' for k, v in shares.items())}; {n_mis} codes differ from "
          f"the plain argmin; {int((counts > 0).sum())} codes used of {n})")


def phase_train(cfg, device, card: str):
    """8 fp32 + 8 bf16 full-width EMA train steps on one fixed batch, then
    eval_step and get_tokens on the fp32-trained model, then the train
    step's time. Returns the path's (B1 launches, B2 launches)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    size = cfg.image_size
    batch = {"image": torch.rand(TRAIN_BATCH, size, size, 3, device=device, generator=gen)}
    lr = cfg.training.scaled_lr()
    trainers, states = {}, {}

    nearest_codes.launches = 0
    nearest_codes_stats.launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        trainer = Trainer(cfg, learning_rate=lr, seed=SEED, steps_per_epoch=STEPS_PER_EPOCH,
                          compute_dtype=dtype, device=device)
        state = trainer.init_state()
        first = _FirstQuantizerCall(state.model.quantizer) if dtype == torch.float32 else None
        history = []
        for _ in range(TRAIN_STEPS):
            state, metrics = trainer.train_step(state, batch, epoch=0)
            history.append(metrics)
            if first is not None:
                torch.cuda.synchronize()
                _check_ema_update(state.model.quantizer, first)
                first.remove()
                first = None
        torch.cuda.synchronize()
        history = [{k: float(v) for k, v in m.items()} for m in history]
        check(all(math.isfinite(v) for m in history for v in m.values()),
              f"train slice {name}: every metric finite")
        losses = [m["loss"] for m in history]
        print(f"train slice {name}: {TRAIN_STEPS} steps at batch {TRAIN_BATCH}, lr "
              f"{history[0]['lr']:.6g}, loss " + " ".join(f"{v:.5f}" for v in losses)
              + f"; quant_loss {history[0]['quant_loss']:.5f} -> {history[-1]['quant_loss']:.5f}"
              + f"; usage {int((state.usage_count > 0).sum())} codes used")
        check(losses[-1] < losses[0], f"train slice {name}: loss of step {TRAIN_STEPS} below step 1")
        trainers[dtype], states[dtype] = trainer, state
    torch.cuda.synchronize()
    b2, b1_train = nearest_codes_stats.launches, nearest_codes.launches
    print(f"train slice: {2 * TRAIN_STEPS} train steps launched nearest_codes_stats {b2} times, "
          f"nearest_codes {b1_train} times")
    check(b2 == 2 * TRAIN_STEPS and b1_train == 0,
          f"the train steps launched nearest_codes_stats {2 * TRAIN_STEPS} times and "
          "nearest_codes never")

    trainer, state = trainers[torch.float32], states[torch.float32]
    mask = torch.ones(TRAIN_BATCH, dtype=torch.bool, device=device)
    mask[-3:] = False
    metrics, usage, recon = trainer.eval_step(state, {"image": batch["image"], "mask": mask},
                                              epoch=0)
    tokens = state.model.get_tokens(batch["image"])
    torch.cuda.synchronize()
    b1 = nearest_codes.launches
    check(b1 == 2 and nearest_codes_stats.launches == b2,
          "eval_step and get_tokens launched nearest_codes twice and nearest_codes_stats never")
    n_valid = int(mask.sum())
    seq = cfg.latent_size ** 2
    check(all(math.isfinite(float(v)) for v in metrics.values())
          and int(metrics["n_valid"]) == n_valid and int(usage.sum()) == n_valid * seq
          and recon.shape == batch["image"].shape, "eval_step: finite metrics, masked usage")
    check(tokens.shape == (TRAIN_BATCH, seq) and bool(((tokens >= 0) & (tokens < usage.numel())).all()),
          "get_tokens on the trained model: shape and range")
    with torch.inference_mode():
        z = state.model.encode(preprocess_batch(batch["image"]))
        flat = z.reshape(-1, z.shape[-1])
        cb = state.model.quantizer.codebook.weight
        _agree(flat, cb, tokens.reshape(-1), nearest_codes_reference(flat, cb),
               f"train slice: get_tokens on the trained model vs plain "
               f"({near_ties(flat.contiguous(), cb.contiguous())} near ties rescored)")
    print(f"train slice: eval_step {{{', '.join(f'{k}: {float(v):.5f}' for k, v in metrics.items())}}}, "
          f"usage {int(usage.sum())} rows; get_tokens {tuple(tokens.shape)}; the path launched "
          f"nearest_codes {b1} times and nearest_codes_stats {b2} times")

    for dtype, trainer in trainers.items():
        state = states[dtype]
        ms = cuda_ms(lambda: trainer.train_step(state, batch, epoch=0), reps=1)
        print(f"time [{card}]: train_step ema {str(dtype).removeprefix('torch.')} batch "
              f"{TRAIN_BATCH}: {ms:.2f} ms, {TRAIN_BATCH * 1000 / ms:.1f} images/s")
    return b1, b2


def device_ms(fn, key: str, tries: int = 3) -> dict:
    """Device time per call of each kernel whose name holds ``key``, from
    ``torch.profiler`` over a few calls (the host's enqueue time excluded);
    -> {name: ms}. A profiler window that recorded none of them (the
    profiler drops a window's device events now and then) is taken again, up
    to ``tries`` windows; -> {} if every one came back empty."""
    for _ in range(tries):
        _, _, per_kernel = profile_tokenizer.profile_call(fn)
        found = {name: ms / profile_tokenizer.CALLS for name, (_, ms) in per_kernel.items()
                 if key in name}
        if found:
            return found
    return {}


def _ms(value) -> str:
    return "not measured" if value is None else f"{value:.4f} ms"


def _reach(bound: float, dev) -> str:
    return "not measured" if dev is None else f"{bound / dev:.1%}"


def _short(name: str) -> str:
    found = re.search(r"nearest_codes\w*?_kernel", name)
    return found.group(0) if found else name


def near_ties(x, cb) -> int:
    """How many rows of (x, cb) B1's merge puts on its fp32 rescoring list."""
    m, n = x.shape[0], cb.shape[0]
    splits = vq_cuda.scan_splits(m, n, torch.cuda.get_device_properties(x.device)
                                 .multi_processor_count)
    _, scratch = vq_cuda._launch_scan(x, cb, splits)
    return vq_cuda.listed_rows(scratch, m, splits)


def _scan_sweep(device, card: str) -> None:
    """B1's launches at the split the wrapper picks and at others (the
    wrapper's work but its checks and count), timed by CUDA events and by
    the device time of its kernels: the evidence for ``scan_splits``."""
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for (m, n, d), sweep in SPLIT_SWEEP.items():
        x = torch.randn(m, d, device=device, generator=gen)
        cb = torch.randn(n, d, device=device, generator=gen)
        picked = vq_cuda.scan_splits(m, n, sms)
        fns, near = {}, {}
        for splits in sorted({*sweep, picked}):
            fns[splits] = functools.partial(vq_cuda._launch_scan, x, cb, splits)
            near[splits] = vq_cuda.listed_rows(fns[splits]()[1], m, splits)
        t = _turns(fns, reps=20)
        dev = {k: sum(device_ms(fn, "nearest_codes").values()) or None for k, fn in fns.items()}
        print(f"time [{card}]: nearest_codes ({m},{n},{d}) launches (c2, scan, merge, "
              f"rescoring) by code ranges (row tiles {-(-m // vq_cuda.BM)}; scan_splits picks "
              f"{picked}; Gaussian rows, {near[picked]} of {m} near ties rescored): "
              + ", ".join(f"{k} ranges {v[0]:.4f} ms (device {_ms(dev[k])})"
                          for k, v in t.items()))


def _turns(fns: dict, reps: int, windows: int = 5, warmup: int = 2) -> dict:
    """Median ms of each function, timed in turns a, b, ..., ..., b, a so that
    every side sees the same card state; -> {name: (mean ms, [window ms])}."""
    order = list(fns) + list(reversed(fns))
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(cuda_ms(fns[k], reps=reps, windows=windows, warmup=warmup))
    return {k: (statistics.mean(v), v) for k, v in times.items()}


def phase_times(cfg, model, device, card: str):
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    rows = {}
    for m, n, d in B1_TIMED:
        x = torch.randn(m, d, device=device, generator=gen)
        cb = torch.randn(n, d, device=device, generator=gen)
        c2 = (cb ** 2).sum(1)
        t = _turns({"plain": lambda: nearest_codes_reference(x, cb),
                    "kernel": lambda: vq_cuda.nearest_codes_cuda(x, cb),
                    # one cuBLAS GEMM with the |c|^2 bias fused, then argmin
                    "library": lambda: torch.addmm(c2, x, cb.T, alpha=-2).argmin(1)}, reps=20)
        b_ms, b_by, ffma = bound_3xtf32(m, n, d, 4 * (m * d + n * d + m))
        dev_ms = sum(device_ms(lambda: vq_cuda.nearest_codes_cuda(x, cb),
                               "nearest_codes").values()) or None
        lib_dev = sum(device_ms(lambda: torch.addmm(c2, x, cb.T, alpha=-2).argmin(1),
                                "").values()) or None
        rows[(m, n, d)] = {k: v[0] for k, v in t.items()} | {"bound": b_ms, "bound_by": b_by,
                                                             "device": dev_ms}
        k_ms, l_ms = t["kernel"][0], t["library"][0]
        print(f"time [{card}]: nearest_codes ({m},{n},{d}) kernel {k_ms:.4f} ms "
              f"(windows {t['kernel'][1][0]:.4f}, {t['kernel'][1][1]:.4f}; device time of the "
              f"scan + merge {_ms(dev_ms)}), plain matmul+argmin {t['plain'][0]:.4f} ms, "
              f"addmm+argmin {l_ms:.4f} ms (device time {_ms(lib_dev)}); bound {b_ms:.4f} ms "
              f"({b_by}, at the 3xTF32 tensor-core rate; the scan's device time reaches "
              f"{_reach(b_ms, dev_ms)} of it), FFMA bound {ffma:.4f} ms; kernel "
              f"{'below' if k_ms < l_ms else 'NOT below'} addmm+argmin")
    _scan_sweep(device, card)
    b1 = rows[B1_TIMED[0]]

    m, n, d = STATS_SHAPES[0]
    x = torch.randn(m, d, device=device, generator=gen)
    cb = torch.randn(n, d, device=device, generator=gen)

    def library_stats():
        # cuBLAS GEMM + argmin + bincount + index_add_ (atomics: not bit-stable)
        codes = torch.addmm((cb ** 2).sum(1), x, cb.T, alpha=-2).argmin(1)
        counts = torch.bincount(codes, minlength=n).float()
        return codes, counts, torch.zeros(n, d, device=device).index_add_(0, codes, x)

    t = _turns({"plain": lambda: nearest_codes_stats_reference(x, cb),
                "kernel": lambda: vq_cuda.nearest_codes_stats_cuda(x, cb),
                "library": library_stats}, reps=10)
    b_ms, b_by, ffma = bound_3xtf32(m, n, d, 4 * (m * d + n * d + m + n + n * d),
                                    fp32_flops=m * d)
    parts = device_ms(lambda: vq_cuda.nearest_codes_stats_cuda(x, cb), "nearest_codes_stats")
    dev_ms = sum(parts.values()) or None
    b2 = {k: v[0] for k, v in t.items()} | {"bound": b_ms, "bound_by": b_by, "device": dev_ms}
    k_ms, l_ms = t["kernel"][0], t["library"][0]
    print(f"time [{card}]: nearest_codes_stats ({m},{n},{d}) kernel {k_ms:.4f} ms "
          f"(windows {t['kernel'][1][0]:.4f}, {t['kernel'][1][1]:.4f}; device time "
          f"{_ms(dev_ms)}: " + ", ".join(f"{_short(k)} {v:.4f}" for k, v in parts.items())
          + f"), plain "
          f"{t['plain'][0]:.4f} ms, matmul+argmin+bincount+index_add_ {l_ms:.4f} ms; "
          f"bound {b_ms:.4f} ms ({b_by}, at the 3xTF32 tensor-core rate; the device time "
          f"reaches {_reach(b_ms, dev_ms)} of it), FFMA bound {ffma:.4f} ms; kernel "
          f"{'below' if k_ms < l_ms else 'NOT below'} the composition")
    # the sums' pass splits the work by code: rows piled on one code fall on one block
    skewed = cb[7] + 0.01 * torch.randn(m, d, device=device, generator=gen)
    used = int((vq_cuda.nearest_codes_stats_cuda(skewed, cb)[1] > 0).sum())
    ms = cuda_ms(lambda: vq_cuda.nearest_codes_stats_cuda(skewed, cb), reps=10)
    print(f"time [{card}]: nearest_codes_stats ({m},{n},{d}) with every row near one code "
          f"({used} codes used): kernel {ms:.4f} ms")

    size = cfg.image_size
    images = torch.rand(TIMED_BATCH, size, size, 3, device=device, generator=gen)
    tokens = model.get_tokens(images)
    for name, fn in (("get_tokens", lambda: model.get_tokens(images)),
                     ("reconstruct", lambda: model.reconstruct(images)),
                     ("reconstruct_from_tokens", lambda: model.reconstruct_from_tokens(tokens))):
        ms = cuda_ms(fn, reps=2)
        print(f"time [{card}]: {name} fp32 batch {TIMED_BATCH}: {ms:.2f} ms, "
              f"{TIMED_BATCH * 1000 / ms:.1f} images/s")
    model_bf16 = VQVAE.from_config(cfg, dtype=torch.bfloat16, device=device,
                                   generator=torch.Generator().manual_seed(SEED))
    recon = model_bf16.reconstruct(images)
    check(bool(torch.isfinite(recon).all()), "bf16 reconstruct finite")
    ms = cuda_ms(lambda: model_bf16.reconstruct(images), reps=2)
    print(f"time [{card}]: reconstruct bf16 batch {TIMED_BATCH}: {ms:.2f} ms, "
          f"{TIMED_BATCH * 1000 / ms:.1f} images/s")
    return b1, b2


def _blur_t(x):
    """The plain version's blur-transpose (B3's first half) of an fp32 tensor."""
    t = torch.tensor(fused_dbwd.TAPS)
    return upfirdn2d(x, torch.outer(t, t).numpy(), padding=1, flip_filter=True)


def _check_b3(dy, p0, b0, what: str) -> float:
    """B3 against the plain version on the same inputs; returns max |dp0 - plain|."""
    alpha, gain = 0.2, math.sqrt(2)
    dp, db = fused_dbwd_cuda.blur_t_gate_cuda(dy, p0, b0, fused_dbwd.TAPS, alpha, gain)
    # blur_t_gate_reference's arithmetic in fp32 (for bf16, before its last
    # rounding): the gate from p0 + b0 summed in p0's dtype
    s = p0 + b0.to(p0.dtype)[None, :, None, None]
    gate = torch.where(s >= 0, gain, gain * alpha).float()
    del s
    plain = _blur_t(dy.float()) * gate
    err = (dp.float() - plain).abs()
    terms = _blur_t(dy.float().abs()) * gate
    if dp.dtype == torch.float32:
        share = float((err / (FP32_SHARE * terms + 1e-30)).max())
    else:
        share = float((err / (BF16_ULP * plain.abs() + FP32_SHARE * terms + 1e-30)).max())
    max_err = float(err.max())
    del err, terms, gate
    db_exact = plain.double().sum((0, 2, 3))
    db_share = float(((db.double() - db_exact).abs()
                      / (DB_SHARE * plain.double().abs().sum((0, 2, 3)) + 1e-30)).max())
    again = fused_dbwd_cuda.blur_t_gate_cuda(dy, p0, b0, fused_dbwd.TAPS, alpha, gain)
    same = torch.equal(dp, again[0]) and torch.equal(db, again[1])
    print(f"{what}: max |dp0 - plain| {max_err:.3e} (worst share of the limit {share:.3f}), "
          f"db0 vs float64 sum worst share {db_share:.3f}, second launch "
          f"{'bit-identical' if same else 'DIFFERENT'}")
    check(share <= 1 and db_share <= 1 and same, what)
    return max_err


def _check_b4(dc, dys, what: str) -> float:
    """B4 against the plain version on the same inputs; returns max |out - plain|."""
    out = fused_dbwd_cuda.skip_fanout_bwd_cuda(dc, dys, fused_dbwd.TAPS)
    plain = fused_dbwd.skip_fanout_bwd_reference(dc.float(), dys.float(), fused_dbwd.TAPS)
    terms = dc.float().abs() + fused_dbwd.skip_fanout_bwd_reference(
        torch.zeros_like(plain), dys.float().abs(), fused_dbwd.TAPS)
    err = (out.float() - plain).abs()
    limit = FP32_SHARE * terms + (BF16_ULP * plain.abs() if out.dtype == torch.bfloat16
                                  else 0.0)
    share = float((err / (limit + 1e-30)).max())
    same = torch.equal(out, fused_dbwd_cuda.skip_fanout_bwd_cuda(dc, dys, fused_dbwd.TAPS))
    print(f"{what}: max |out - plain| {float(err.max()):.3e} (worst share of the limit "
          f"{share:.3f}), second launch {'bit-identical' if same else 'DIFFERENT'}")
    check(share <= 1 and same, what)
    return float(err.max())


def phase_dbwd_kernels(device):
    """B3 and B4 against their plain versions at the D's block shapes (at
    the GAN slice's batch and at the CLI's GAN micro-batch, phase 10 (c)) and
    at ragged ones, fp32 and bf16. Returns (B3 max error, B4 max error)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    shapes = [(b, c, h, h) for b in (DBWD_BATCH, CLI_GAN_BATCH // CLI_GAN_ACCUM)
              for c, h in DBWD_BLOCKS] + DBWD_RAGGED
    b3_err = b4_err = 0.0
    for b, c, h, w in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            dy = torch.randn(b, c, h + 1, w + 1, device=device, generator=gen).to(dtype)
            p0 = torch.randn(b, c, h, w, device=device, generator=gen).to(dtype)
            b0 = 0.1 * torch.randn(c, device=device, generator=gen)
            b3_err = max(b3_err, _check_b3(dy, p0, b0, f"B3 vs plain ({b},{c},{h},{w}) {name}"))
            del dy, p0
            dc = torch.randn(b, c, h, w, device=device, generator=gen).to(dtype)
            dys = torch.randn(b, c, h // 2, w // 2, device=device, generator=gen).to(dtype)
            b4_err = max(b4_err, _check_b4(dc, dys, f"B4 vs plain ({b},{c},{h},{w}) {name}"))
            del dc, dys
            torch.cuda.empty_cache()
    return b3_err, b4_err


def _dbwd_counts():
    return fused_dbwd.blur_t_gate.launches, fused_dbwd.skip_fanout_bwd.launches


def _reset_counts():
    nearest_codes.launches = nearest_codes_stats.launches = 0
    fused_dbwd.blur_t_gate.launches = fused_dbwd.skip_fanout_bwd.launches = 0


class _ShapeTally:
    """Counts B3's and B4's launches by kernel and shape while it is entered:
    the wrappers stay the ones that launch (and count) the kernels."""

    def __init__(self):
        self.counts = collections.Counter()

    def __enter__(self):
        self._real = fused_dbwd_cuda.blur_t_gate_cuda, fused_dbwd_cuda.skip_fanout_bwd_cuda
        real_b3, real_b4 = self._real

        def b3(dy, p0, *args):
            self.counts[("B3", tuple(p0.shape))] += 1
            return real_b3(dy, p0, *args)

        def b4(dc, dys, *args):
            self.counts[("B4", tuple(dc.shape))] += 1
            return real_b4(dc, dys, *args)

        fused_dbwd_cuda.blur_t_gate_cuda, fused_dbwd_cuda.skip_fanout_bwd_cuda = b3, b4
        return self

    def __exit__(self, *exc):
        fused_dbwd_cuda.blur_t_gate_cuda, fused_dbwd_cuda.skip_fanout_bwd_cuda = self._real


def _grad_shares(a: dict, b: dict) -> dict:
    """Per tensor: max |a - b| over max |b|, that at least 1e-3 of the module's
    largest gradient entry (a bias just before a GroupNorm has a gradient
    that is 0 but for rounding)."""
    floor = 1e-3 * max(float(v.abs().max()) for v in b.values())
    return {k: float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), floor)
            for k in b}


def _fused_ab(cfg, batch, device, what: str) -> None:
    """The composed-program check: one non-R1 fp32 step of ``cfg`` from the
    same weights, batch and noise, the D's backward fused against plain.
    Every autoencoder and D gradient, and ``g_weight`` (the adaptive lambda
    where the config asks for it), agree within ``GRAD_SHARE``."""
    n_blocks = len(range(int(math.log2(cfg.image_size)), 2, -1))
    runs = {}
    for fused in (True, False):
        trainer = Trainer(cfg, learning_rate=cfg.training.scaled_lr(), seed=SEED,
                          steps_per_epoch=STEPS_PER_EPOCH, device=device, fused_dbwd=fused,
                          fused_skip=fused)
        state = trainer.init_state()
        trainer.host_step = 1                      # not an R1 step
        before = _dbwd_counts()
        _, metrics = trainer.train_step(state, batch, epoch=cfg.loss.adversarial.start_epoch)
        torch.cuda.synchronize()
        runs[fused] = ({k: p.grad for k, p in state.model.named_parameters()},
                       {k: p.grad for k, p in state.disc.named_parameters()},
                       {k: float(v) for k, v in metrics.items()},
                       _dbwd_counts()[0] - before[0], trainer.accum)
        del trainer, state
    (ae_f, d_f, m_f, n_f, accum), (ae_p, d_p, m_p, n_p, _) = runs[True], runs[False]
    # D backward passes per micro-batch: the autoencoder's through the fake
    # logits, the D's fake and real ones, and under use_adaptive the
    # lambda's autograd.grad of the G loss
    passes = 3 + int(cfg.loss.adversarial.use_adaptive)
    check(n_f == passes * n_blocks * accum and n_p == 0,
          f"{what}: the fused step launched B3 {n_f} times ({passes * n_blocks} per "
          f"micro-batch), the plain one {n_p} times")
    ae_share, d_share = _grad_shares(ae_f, ae_p), _grad_shares(d_f, d_p)
    worst_ae = max(ae_share, key=ae_share.get)
    worst_d = max(d_share, key=d_share.get)
    g_share = abs(m_f["g_weight"] - m_p["g_weight"]) / max(abs(m_p["g_weight"]), 1e-30)
    print(f"{what} fp32 non-R1 step at {accum} micro-batch(es) of "
          f"{batch['image'].shape[0] // accum}, fused vs plain on the same weights and batch: "
          f"loss {m_f['loss']:.7f} vs {m_p['loss']:.7f}, disc_loss {m_f['disc_loss']:.7f} vs "
          f"{m_p['disc_loss']:.7f}, g_weight {m_f['g_weight']:.7g} vs {m_p['g_weight']:.7g} "
          f"(share {g_share:.3e}); worst autoencoder gradient share {ae_share[worst_ae]:.3e} "
          f"({worst_ae}), worst D gradient share {d_share[worst_d]:.3e} ({worst_d}); limit "
          f"{GRAD_SHARE} of each tensor's largest entry")
    check(ae_share[worst_ae] <= GRAD_SHARE and d_share[worst_d] <= GRAD_SHARE
          and g_share <= GRAD_SHARE,
          f"{what}: fused gradients and g_weight equal the plain ones inside the composed step")


def phase_gan(cfg, device, card: str):
    """The GAN slice: 4 bf16 + 4 fp32 full-width steps with the fused D
    backward, the composed-step A/B, eval_step. Returns (B3 launches, B4
    launches, the bf16 and fp32 trainers and states)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    size = cfg.image_size
    batch = {"image": torch.rand(GAN_BATCH, size, size, 3, device=device, generator=gen)}
    adv = cfg.loss.adversarial
    epoch = adv.start_epoch
    lr = cfg.training.scaled_lr()
    n_blocks = len(range(int(math.log2(size)), 2, -1))
    runs, shape_launches = {}, {}
    _reset_counts()
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        trainer = Trainer(cfg, learning_rate=lr, seed=SEED, steps_per_epoch=STEPS_PER_EPOCH,
                          compute_dtype=dtype, device=device, fused_dbwd=True, fused_skip=True)
        state = trainer.init_state()
        check(trainer.gan_active(epoch) and not trainer.gan_active(epoch - 1),
              f"gan slice {name}: the GAN starts at epoch {epoch}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        history, per_step = [], []
        for i in range(GAN_STEPS):
            before = _dbwd_counts()
            with _ShapeTally() as tally:
                state, metrics = trainer.train_step(state, batch, epoch=epoch)
            torch.cuda.synchronize()
            after = _dbwd_counts()
            per_step.append((after[0] - before[0], after[1] - before[1]))
            history.append({k: float(v) for k, v in metrics.items()})
            if dtype == torch.bfloat16 and i < 2:   # host step 0 is R1, 1 is not
                shape_launches["R1" if i == 0 else "non-R1"] = tally.counts
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(all(math.isfinite(v) for m in history for v in m.values()),
              f"gan slice {name}: every metric finite")
        r1 = [m["r1_penalty"] for m in history]
        check(r1[0] > 0 and all(v == 0 for v in r1[1:]),
              f"gan slice {name}: r1_penalty > 0 on the R1 step (host step 0) only")
        want = [(2 * n_blocks,) * 2] + [(3 * n_blocks,) * 2] * (GAN_STEPS - 1)
        check(per_step == want, f"gan slice {name}: B3/B4 launches per step {per_step}, "
              f"expected {want}")
        print(f"gan slice {name}: {GAN_STEPS} steps at batch {GAN_BATCH}, epoch {epoch}, lr "
              f"{history[0]['lr']:.6g}; loss " + " ".join(f"{m['loss']:.5f}" for m in history)
              + "; gen_loss " + " ".join(f"{m['gen_loss']:.5f}" for m in history)
              + "; disc_loss " + " ".join(f"{m['disc_loss']:.5f}" for m in history)
              + "; r1_penalty " + " ".join(f"{v:.5g}" for v in r1)
              + f"; perc_loss {history[0]['perc_loss']:.5f}; B3/B4 launches per step "
              f"{[a for a, _ in per_step]} (R1 step: {2 * n_blocks} = {n_blocks} blocks x 2 "
              f"fake-logit backward passes; others: {3 * n_blocks}, the real logits' too); "
              f"peak memory {peak:.2f} GiB [{card}]")
        runs[dtype] = (trainer, state)
    b3, b4 = _dbwd_counts()
    check(nearest_codes.launches == 0 and nearest_codes_stats.launches == 0,
          "the GAN path launched neither nearest_codes nor nearest_codes_stats")
    check(b3 > 0 and b4 > 0, "the GAN path launched B3 and B4")
    print(f"gan slice: {2 * GAN_STEPS} train steps launched blur_t_gate {b3} times, "
          f"skip_fanout_bwd {b4} times, nearest_codes 0, nearest_codes_stats 0")
    for kind, counts in shape_launches.items():
        print(f"gan slice bf16 {kind} step: launches by shape "
              + ", ".join(f"{k} {shape} x{n}" for (k, shape), n in sorted(counts.items())))

    _fused_ab(cfg, batch, device, "gan A/B")
    torch.cuda.empty_cache()

    trainer, state = runs[torch.float32]
    mask = torch.ones(GAN_BATCH, dtype=torch.bool, device=device)
    mask[-4:] = False
    metrics, usage, recon = trainer.eval_step(state, {"image": batch["image"], "mask": mask},
                                              epoch=epoch)
    torch.cuda.synchronize()
    n_valid = int(mask.sum())
    check(all(math.isfinite(float(v)) for v in metrics.values())
          and int(metrics["n_valid"]) == n_valid
          and int(usage.sum()) == n_valid * cfg.latent_size ** 2
          and recon.shape == batch["image"].shape
          and float(metrics["gen_loss"]) > 0 and float(metrics["disc_loss"]) > 0,
          "gan eval_step: finite metrics, G and D losses, masked usage")
    print(f"gan eval_step fp32: {{{', '.join(f'{k}: {float(v):.5f}' for k, v in metrics.items())}}}")
    return b3, b4, runs, batch, shape_launches


def phase_gan_times(cfg, runs, batch, card: str) -> None:
    """The GAN step, R1 and not, with the fused D backward and without, in turns."""
    epoch = cfg.loss.adversarial.start_epoch
    every = cfg.loss.adversarial.r1_reg_every
    for dtype, (trainer, state) in runs.items():
        name = str(dtype).removeprefix("torch.")
        for r1 in (False, True):
            def step(fused, r1=r1, trainer=trainer, state=state):
                def fn():
                    state.disc.set_fused(fused, fused)
                    trainer.host_step = 0 if r1 else 1
                    trainer.train_step(state, batch, epoch=epoch)
                return fn
            # an R1 step takes ~30x a plain one (PERF.md): one window each, no
            # warm-up (phase_gan has run one already), to keep the script short
            t = _turns({"plain": step(False), "fused": step(True)}, reps=1,
                       windows=1 if r1 else 3, warmup=0 if r1 else 1)
            kind = "R1" if r1 else "non-R1"
            print(f"time [{card}]: gan train_step {kind} {name} batch {GAN_BATCH}: fused D "
                  f"backward {t['fused'][0]:.2f} ms ({GAN_BATCH * 1000 / t['fused'][0]:.1f} "
                  f"images/s; windows {', '.join(f'{v:.2f}' for v in t['fused'][1])}), plain "
                  f"{t['plain'][0]:.2f} ms ({GAN_BATCH * 1000 / t['plain'][0]:.1f} images/s; "
                  f"windows {', '.join(f'{v:.2f}' for v in t['plain'][1])}); one R1 step every "
                  f"{every}")
        state.disc.set_fused(True, True)


def phase_dbwd_times(device, card: str, shape_launches: dict) -> dict:
    """B3 and B4 at every D block shape (batch 32), fp32 and bf16: kernel (CUDA
    events around the wrapper, and the kernel's device time from the
    profiler), plain version, one PyTorch composition, bound by bytes, and
    the device time of B3's counter memset; the launches of each shape in a GAN step (from ``phase_gan``) and, per step,
    the sum of launches x (time - bound). Returns {(kernel, dtype, shape):
    times}."""
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    alpha, gain = 0.2, math.sqrt(2)
    t4 = torch.tensor(fused_dbwd.TAPS, device=device)
    f2d = torch.outer(t4, t4)
    rows = {}
    for c, h in DBWD_BLOCKS:
        b, w = DBWD_BATCH, h
        shape = (b, c, h, w)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            size = torch.finfo(dtype).bits // 8
            dy = torch.randn(b, c, h + 1, w + 1, device=device, generator=gen).to(dtype)
            p0 = torch.randn(b, c, h, w, device=device, generator=gen).to(dtype)
            b0 = torch.randn(c, device=device, generator=gen)
            wdw = f2d.to(dtype)[None, None].expand(c, 1, 4, 4).contiguous()

            def library_b3():
                da = torch.nn.functional.conv2d(dy, wdw, padding=1, groups=c)
                s = p0 + b0.to(dtype)[None, :, None, None]
                dp = da * torch.where(s >= 0, gain, gain * alpha).to(dtype)
                return dp, dp.float().sum((0, 2, 3))

            def kernel_b3():
                return fused_dbwd_cuda.blur_t_gate_cuda(dy, p0, b0, fused_dbwd.TAPS, alpha, gain)

            t = _turns({"plain": lambda: fused_dbwd.blur_t_gate_reference(dy, p0, b0),
                        "kernel": kernel_b3, "library": library_b3}, reps=10)
            n = b * c * h * w
            b_ms, b_by = bound(19 * n, size * (b * c * (h + 1) * (w + 1) + 2 * n) + 8 * c)
            events = device_ms(kernel_b3, "")
            dev = sum(ms for k, ms in events.items() if "blur_t_gate_kernel" in k) or None
            zeroing = sum(ms for k, ms in events.items() if "emset" in k) or None
            rows[("B3", dtype, shape)] = ({k: v[0] for k, v in t.items()}
                                          | {"bound": b_ms, "bound_by": b_by, "device": dev})
            _print_dbwd(card, "blur_t_gate", shape, name, t, b_ms, b_by, dev,
                        "depthwise conv2d + where + sum", shape_launches, ("B3", shape))
            print(f"time [{card}]: blur_t_gate {shape} {name}: device time of the memset "
                  f"that zeroes its {c} arrival counters before each launch (in the kernel's "
                  f"time) {_ms(zeroing)}")
            del dy, p0
            dc = torch.randn(b, c, h, w, device=device, generator=gen).to(dtype)
            dys = torch.randn(b, c, h // 2, w // 2, device=device, generator=gen).to(dtype)

            def kernel_b4():
                return fused_dbwd_cuda.skip_fanout_bwd_cuda(dc, dys, fused_dbwd.TAPS)

            t = _turns({"plain": lambda: fused_dbwd.skip_fanout_bwd_reference(dc, dys),
                        "kernel": kernel_b4,
                        "library": lambda: dc + torch.nn.functional.conv_transpose2d(
                            dys, wdw, stride=2, padding=1, groups=c)}, reps=10)
            b_ms, b_by = bound(13 * n, size * (2 * n + n // 4))
            dev = sum(device_ms(kernel_b4, "skip_fanout_bwd_kernel").values()) or None
            rows[("B4", dtype, shape)] = ({k: v[0] for k, v in t.items()}
                                          | {"bound": b_ms, "bound_by": b_by, "device": dev})
            _print_dbwd(card, "skip_fanout_bwd", shape, name, t, b_ms, b_by, dev,
                        "conv_transpose2d + add", shape_launches, ("B4", shape))
            del dc, dys
            torch.cuda.empty_cache()
    # per GAN step: launches x (time - bound), summed over the shapes
    for dtype in (torch.float32, torch.bfloat16):
        for kind, counts in shape_launches.items():
            for k in ("B3", "B4"):
                lost = [n * (rows[(k, dtype, shape)]["kernel"] - rows[(k, dtype, shape)]["bound"])
                        for (kk, shape), n in counts.items() if kk == k]
                busy = [n * rows[(k, dtype, shape)]["kernel"]
                        for (kk, shape), n in counts.items() if kk == k]
                print(f"time [{card}]: {k} {str(dtype).removeprefix('torch.')} per {kind} GAN "
                      f"step: {sum(n for (kk, _), n in counts.items() if kk == k)} launches, "
                      f"sum of launches x ms {sum(busy):.4f} ms, sum of launches x (ms - bound) "
                      f"{sum(lost):.4f} ms")
    return rows


def _print_dbwd(card, name, shape, dtype, t, b_ms, b_by, dev, library, shape_launches, key):
    per_step = ", ".join(f"{kind} step x{counts.get(key, 0)}"
                         for kind, counts in shape_launches.items())
    print(f"time [{card}]: {name} {shape} {dtype} kernel {t['kernel'][0]:.4f} ms (windows "
          f"{t['kernel'][1][0]:.4f}, {t['kernel'][1][1]:.4f}; device {_ms(dev)}), plain "
          f"{t['plain'][0]:.4f} ms, {library} {t['library'][0]:.4f} ms; bound {b_ms:.4f} ms "
          f"({b_by}; the kernel reaches {b_ms / t['kernel'][0]:.1%} of it, its device time "
          f"{_reach(b_ms, dev)}); launches per GAN step: {per_step}")


@contextmanager
def _tf32(matmul: bool, cudnn: bool):
    """TF32 for matmuls and convolutions set while it is entered."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _write_packs(root: Path, n_train: int, n_val: int, size: int, seed: int) -> None:
    """Seeded uint8 images in ``train.pack`` and ``validation.pack``."""
    rs = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    for name, n in (("train", n_train), ("validation", n_val)):
        write_packed(str(root / f"{name}.pack"),
                     (rs.randint(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(n)), size)


def _yaml(path: Path, base: Path, change) -> str:
    raw = yaml.safe_load(base.read_text())
    change(raw)
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _records(run_dir: Path) -> list:
    return [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]


def _cli(params_file: str, data: Path, save: Path, run: str, *extra):
    return cli_train.main(["--params_file", params_file, "--dataloader", "packed",
                           "--dataset_path", str(data), "--save_path", str(save),
                           "--run_name", run, "--seed", str(SEED), "--workers", "4", *extra])


class _StepSpy:
    """While it is entered, records around each ``Trainer.train_step`` two
    CUDA events on the stream, with no synchronisation between steps (the
    loop's overlap of loader and host copies with the card's work stays),
    and the peak memory of training and of each ``run_validation``. Once
    left, ``steps`` holds each step's (ms on the stream, images, metrics)."""

    def __init__(self):
        self.steps, self.val_peaks, self.train_peak = [], [], 0

    def __enter__(self):
        real_step, real_val = loop.Trainer.train_step, loop.run_validation
        self._events = []

        def train_step(trainer, state, batch, epoch):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = real_step(trainer, state, batch, epoch)
            end.record()
            self._events.append((start, end, batch["image"].shape[0], out[1]))
            return out

        def run_validation(*args, **kwargs):
            torch.cuda.synchronize()
            self.train_peak = max(self.train_peak, torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            out = real_val(*args, **kwargs)
            torch.cuda.synchronize()
            self.val_peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            return out

        self._patches = ExitStack()
        self._patches.enter_context(mock.patch.object(loop.Trainer, "train_step", train_step))
        self._patches.enter_context(mock.patch.object(loop, "run_validation", run_validation))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return self

    def __exit__(self, *exc):
        self._patches.close()
        torch.cuda.synchronize()
        self.train_peak = max(self.train_peak, torch.cuda.max_memory_allocated())
        self.steps = [(start.elapsed_time(end), n, {k: float(v) for k, v in m.items()})
                      for start, end, n, m in self._events]


def _finite_losses(run_dir: Path, what: str) -> None:
    records = _records(run_dir)
    check(bool(records) and all(math.isfinite(v) for r in records for v in r.values()),
          f"{what}: every logged value finite")


def _leg_ema(tmp: Path, card: str) -> tuple:
    """Leg (a): ema_vqvae.yaml at grad_accum_steps 8 with reinit every epoch,
    one epoch, then a resume from last/ for a second. -> (B1, B2 launches)."""
    params = _yaml(tmp / "ema_accum.yaml", TRAIN_CONFIG, lambda raw: (
        raw["training"].update(grad_accum_steps=CLI_ACCUM),
        raw["quantizer"].update(reinit_every_n_epochs=1)))
    seen = {}
    real_reinit = loop.Trainer.maybe_reinit_codes

    def reinit(trainer, state, epoch):
        q = state.model.quantizer
        before = (state.usage_count.clone(), q.codebook.weight.clone())
        out = real_reinit(trainer, state, epoch)
        seen[epoch] = before + tuple(t.clone() for t in (q.codebook.weight, q.ema_weight,
                                                          q.ema_count))
        return out

    save = tmp / "ckpt"
    _reset_counts()
    with mock.patch.object(loop.Trainer, "maybe_reinit_codes", reinit), _StepSpy() as spy:
        state, _ = _cli(params, tmp / "data", save, "ema", "--max_epochs", "1")
        torch.cuda.synchronize()
        first_steps = state.step
        b2_first = nearest_codes_stats.launches
        state, _ = _cli(params, tmp / "data", save, "ema", "--max_epochs", "2",
                        "--loading_path", str(save / "ema" / "last"))
    torch.cuda.synchronize()
    b1, b2 = nearest_codes.launches, nearest_codes_stats.launches
    micro = spy.steps[0][1] // CLI_ACCUM
    print(f"cli (a) ema_vqvae.yaml, grad_accum_steps {CLI_ACCUM}, bf16: {first_steps} + "
          f"{state.step - first_steps} optimizer steps of {CLI_ACCUM} x {micro}; "
          f"nearest_codes_stats launched {b2_first} + {b2 - b2_first} times, nearest_codes "
          f"{b1} times (validation, panels); peak memory training "
          f"{spy.train_peak / 2**30:.2f} GiB, validation {spy.val_peaks[0] / 2**30:.2f} GiB "
          f"[{card}]")
    check(first_steps == CLI_TRAIN_IMAGES // spy.steps[0][1] and state.step == 2 * first_steps,
          "cli (a): one epoch of steps, then a resumed one")
    check(b2_first == CLI_ACCUM * first_steps and b2 == CLI_ACCUM * state.step,
          f"cli (a): nearest_codes_stats launched {CLI_ACCUM} times per optimizer step")
    check(b1 > 0, "cli (a): validation launched nearest_codes")
    run = save / "ema"
    check(all((run / d / "state.pt").is_file() for d in ("epoch_0000", "epoch_0001", "last")),
          "cli (a): epoch_0000/, epoch_0001/ and last/ hold a checkpoint")
    _finite_losses(run, "cli (a)")
    steps = [r["step"] for r in _records(run) if "train/loss" in r]
    check(steps == [first_steps, 2 * first_steps],
          f"cli (a): the resumed run's step continues the first run's ({steps})")
    check(sorted(seen) == [0, 1], "cli (a): maybe_reinit_codes ran at the end of epochs 0, 1")
    usage, cb0, cb1, ema_w, ema_c = seen[1]
    dead = usage == 0
    n_dead = int(dead.sum())
    check(torch.equal(cb1[~dead], cb0[~dead]), "cli (a): the epoch-1 reinit kept the used rows")
    if n_dead:
        nearest = torch.cdist(cb1[dead], cb0[~dead],
                              compute_mode="donot_use_mm_for_euclid_dist").min(1).values
        check(bool((nearest == 0).all()), "cli (a): each dead row became a used row's copy")
        ratio = ema_w[dead] / ema_c[dead, None]
        rel = float(((cb1[dead] - ratio).abs() / ratio.abs().clamp(min=1e-30)).max())
        check(rel <= 1e-6, f"cli (a): replaced rows keep codebook == ema_weight / ema_count "
                           f"(rtol 1e-6; worst {rel:.3g})")
    print(f"cli (a): the epoch-1 reinit replaced {n_dead} dead rows of {usage.numel()} "
          f"(epoch 0 left alone: {torch.equal(seen[0][1], seen[0][2])})")
    check(torch.equal(seen[0][1], seen[0][2]), "cli (a): no reinit at epoch 0")
    return b1, b2


def _leg_recipe(tmp: Path, card: str) -> None:
    """Leg (b): the published one-chip recipe, gumbel_vqgan_1chip.yaml
    unchanged (cumulative_bs 256 = 8 x 32, pre-GAN), one epoch."""
    t = load_config(str(RECIPE_CONFIG)).training
    with _StepSpy() as spy:
        _cli(str(RECIPE_CONFIG), tmp / "data", tmp / "ckpt", "recipe", "--max_epochs", "1")
    run = tmp / "ckpt" / "recipe"
    _finite_losses(run, "cli (b)")
    logged = [r["train/images_per_sec"] for r in _records(run) if "train/images_per_sec" in r]
    times = [t for t, _, _ in spy.steps]
    batch = spy.steps[0][1]
    steady = statistics.mean(times[1:])
    print(f"time [{card}]: cli (b) gumbel_vqgan_1chip.yaml bf16, {len(times)} optimizer steps of "
          f"{t.grad_accum_steps} x {batch // t.grad_accum_steps} (pre-GAN), each step's time on "
          f"the stream by CUDA events, no synchronisation between steps: ms per step "
          + " ".join(f"{t:.1f}" for t in times)
          + f"; steps 2-{len(times)}: mean {steady:.1f} ms/step, {batch * 1000 / steady:.1f} "
          f"images/s; the loop's logged train/images_per_sec over the whole epoch (first step, "
          f"reconstruction panel and loader included) {logged[0]:.1f}; peak memory training "
          f"{spy.train_peak / 2**30:.2f} GiB, validation {spy.val_peaks[0] / 2**30:.2f} GiB in "
          f"chunks of {t.cumulative_bs // t.grad_accum_steps}")
    check(len(times) == CLI_TRAIN_IMAGES // t.cumulative_bs and batch == t.cumulative_bs,
          f"cli (b): one epoch of optimizer steps at cumulative_bs {t.cumulative_bs}")


def _leg_gan(tmp: Path, card: str, device) -> tuple:
    """Leg (c): the GAN with adaptive lambda, cumulative_bs 32 at
    grad_accum_steps 2, the fused D backward on, two steps (R1, then not).
    -> (B3, B4 launches)."""
    params = _yaml(tmp / "gan_adaptive.yaml", RECIPE_CONFIG, lambda raw: (
        raw["loss"]["adversarial_params"].update(start_epoch=0, use_adaptive=True),
        raw["training"].update(cumulative_bs=CLI_GAN_BATCH, grad_accum_steps=CLI_GAN_ACCUM)))
    _reset_counts()
    env = {"VQVAE_TPU_FUSED_DBWD": "1", "VQVAE_TPU_FUSED_SKIP": "1"}
    with mock.patch.dict(os.environ, env), _StepSpy() as spy:
        _cli(params, tmp / "gan_data", tmp / "ckpt", "gan", "--max_epochs", "1")
    torch.cuda.synchronize()
    b3, b4 = _dbwd_counts()
    _finite_losses(tmp / "ckpt" / "gan", "cli (c)")
    g = [m["g_weight"] for _, _, m in spy.steps]
    r1 = [m["r1_penalty"] for _, _, m in spy.steps]
    logged = [r["train/g_weight"] for r in _records(tmp / "ckpt" / "gan") if "train/g_weight" in r]
    print(f"time [{card}]: cli (c) adaptive-lambda GAN, bf16, {CLI_GAN_ACCUM} x "
          f"{CLI_GAN_BATCH // CLI_GAN_ACCUM} per step, fused D backward: ms per step " + " ".join(f"{t:.1f}" for t, _, _ in spy.steps)
          + f"; g_weight {g}, logged {logged}; r1_penalty {r1}; blur_t_gate launched {b3} times, "
          f"skip_fanout_bwd {b4} times; peak memory training {spy.train_peak / 2**30:.2f} GiB")
    check(len(spy.steps) == 2, "cli (c): two optimizer steps")
    check(all(math.isfinite(v) and v > 0 for v in g + logged), "cli (c): g_weight finite and > 0")
    check(r1[0] > 0 and r1[1] == 0, "cli (c): r1_penalty > 0 on step 0 only")
    check(b3 > 0 and b4 > 0, "cli (c): the GAN launched blur_t_gate and skip_fanout_bwd")
    # the leg's config, shapes and data in fp32, fused against plain; these
    # launches come after the leg's counts were read
    reader = PackedDataset(str(tmp / "gan_data" / "train.pack"))
    images = reader.read_batch(np.arange(CLI_GAN_BATCH))
    reader.close()
    with _tf32(False, False):
        _fused_ab(load_config(params), {"image": images}, device, "cli (c) A/B")
    return b3, b4


def phase_cli(card: str, device) -> dict:
    """The port's train CLI in process on the card, in bf16 (its default),
    with torch's default TF32 settings (the CLI's own), on seeded packed data:
    legs (a) EMA with accumulation, reinit and resume; (b) the published
    one-chip recipe; (c) the adaptive-lambda GAN with the fused D backward.
    -> this phase's launches per kernel."""
    size = load_config(str(RECIPE_CONFIG)).image_size
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as name, _tf32(False, True):
        tmp = Path(name)
        _write_packs(tmp / "data", CLI_TRAIN_IMAGES, CLI_VAL_IMAGES, size, SEED + 8)
        _write_packs(tmp / "gan_data", 2 * CLI_GAN_BATCH, CLI_VAL_IMAGES, size, SEED + 9)
        reader = PackedDataset(str(tmp / "data" / "train.pack"))
        lr = build_native_lr_scheduler(1e-4, 3, None, 250)
        print(f"cli: packed reader native {reader.is_native}, LR twin native {lr.is_native}")
        check(reader.is_native and lr.is_native,
              "cli: g++ built the packed reader and the LR twin (no Python twin on the card)")
        reader.close()
        lr.destroy()
        b1, b2 = _leg_ema(tmp, card)
        torch.cuda.empty_cache()
        _leg_recipe(tmp, card)
        torch.cuda.empty_cache()
        b3, b4 = _leg_gan(tmp, card, device)
        torch.cuda.empty_cache()
    return {"nearest_codes": b1, "nearest_codes_stats": b2, "blur_t_gate": b3,
            "skip_fanout_bwd": b4}


def _record(name, source, replaces, launches, max_abs_err, shape, t) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err, "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": t["bound"], "bound_by": t["bound_by"],
            "library_ms": t["library"], "shape": list(shape)}


def _scan_bound(t) -> dict:
    return {"bound_ops": "3xTF32: 3 TF32 passes x 2MND at 495 TFLOP/s",
            "device_ms": t["device"]}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is visible; this script runs only on a GPU")
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    kernel_gap = phase_kernel(device)
    cfg = load_config(str(CONFIG))
    model, b1_tokenizer, slice_gap = phase_slice(cfg, device)
    stats_err = phase_stats_kernel(device)
    train_cfg = load_config(str(TRAIN_CONFIG))
    b1_train, b2_train = phase_train(train_cfg, device, card)
    b3_err, b4_err = phase_dbwd_kernels(device)
    gan_cfg = load_config(str(GAN_CONFIG))
    b3_gan, b4_gan, gan_runs, gan_batch, shape_launches = phase_gan(gan_cfg, device, card)
    b1, b2 = phase_times(cfg, model, device, card)
    phase_gan_times(gan_cfg, gan_runs, gan_batch, card)
    del gan_runs
    torch.cuda.empty_cache()
    b256 = (DBWD_BATCH, DBWD_BLOCKS[0][0], DBWD_BLOCKS[0][1], DBWD_BLOCKS[0][1])
    dbwd = phase_dbwd_times(device, card, shape_launches)
    t_cli = time.perf_counter()
    cli = phase_cli(card, device)
    print(f"time [{card}]: cli: the phase took {time.perf_counter() - t_cli:.1f} s; "
          f"launches {cli}")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [
        # launches: the tokenizer path's, the training path's and the train
        # CLI's (cli_launches: the last alone, counted from 0 for each of its
        # legs); max_abs_err:
        # the largest float64 score gap between the kernel's and the plain
        # version's pick over every compared row (0.0 where all agree)
        # bound_ms: 3 TF32 passes x 2MND on the tensor cores (bound_ops; the
        # FFMA bound is in the time lines); device_ms: the kernels' device
        # time (profiler), ms: CUDA events around the wrapper
        _record("nearest_codes", "vqvae_tpu_torch/csrc/nearest_codes.cu",
                "vqvae_tpu/ops/vq_pallas.py:141", b1_tokenizer + b1_train + cli["nearest_codes"],
                max(kernel_gap, slice_gap), (8192, 1024, 256), b1) | _scan_bound(b1)
        | {"cli_launches": cli["nearest_codes"]},
        # max_abs_err: the largest |dw - dw_plain| over the compared shapes
        _record("nearest_codes_stats", "vqvae_tpu_torch/csrc/nearest_codes_stats.cu",
                "vqvae_tpu/ops/vq_pallas.py:89", b2_train + cli["nearest_codes_stats"], stats_err,
                STATS_SHAPES[0], b2) | _scan_bound(b2)
        | {"cli_launches": cli["nearest_codes_stats"]},
        # launches: the GAN path's 8 train steps and the CLI's leg (c); max_abs_err: the largest
        # |kernel - plain| over every compared shape, fp32 and bf16 (bf16 is
        # one bf16 ulp); times at the first block's shape in bf16, the
        # training compute dtype
        _record("blur_t_gate", "vqvae_tpu_torch/csrc/fused_dbwd.cu",
                "vqvae_tpu/ops/fused_dbwd.py:220", b3_gan + cli["blur_t_gate"], b3_err, b256,
                dbwd[("B3", torch.bfloat16, b256)])
        | {"dtype": "bfloat16", "cli_launches": cli["blur_t_gate"]},
        _record("skip_fanout_bwd", "vqvae_tpu_torch/csrc/fused_dbwd.cu",
                "vqvae_tpu/ops/fused_dbwd.py:386", b4_gan + cli["skip_fanout_bwd"], b4_err, b256,
                dbwd[("B4", torch.bfloat16, b256)])
        | {"dtype": "bfloat16", "cli_launches": cli["skip_fanout_bwd"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
