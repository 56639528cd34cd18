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
   adaptive ``g_weight`` within ``GRAD_SHARE``;
11. eval: on the cli phase's packs, plus a seeded ``test.pack`` of 64 256^2
   images and seeded FID-inception weights (``random_inception_npz``): the
   eval CLI (``vqvae_tpu_torch.cli.evaluate.main``) in process on leg (a)'s
   ``last/`` snapshot (``ema_vqvae.yaml``, N = 4096) at batch 32, fp32 with
   TF32 off, first with ``nearest_codes`` forced to its plain fp32 version,
   then as it is: every metric finite and rFID present, B1 launched once per
   batch (and never in the plain run); the two runs: the same latents, codes
   equal but for near-ties, mse / psnr / ssim within ``METRIC_RTOL``, usage
   and perplexity those of each run's codes; the card's Inception features
   of 8 images against the CPU's within ``FEATURE_SHARE`` of the largest
   entry; the token-export CLI (``cli.tokenize_dataset.main``) at full width
   on ``standard_vqvae.yaml`` and ``entropy_vqvae.yaml`` from seeded random
   weights saved as a port snapshot, over the 1280 train images at batch 64:
   B1 once per batch, the ``.npy`` equal to B1's codes, those against plain
   fp32 argmin on the card by the near-tie rule; 4 bf16 and 2 fp32
   ``entropy_vqvae.yaml`` train steps at batch 32 (finite; each step's
   quantizer loss within ``ENTROPY_LOSS_RTOL`` of a float64 recomputation on
   its latents; no nearest-code kernel: the entropy forward takes the
   library matmul, as JAX's); times: evaluate_checkpoint images/s, the
   Inception batch, ``FID.compute``'s host time, tokenize images/s, the
   entropy step;
12. ddp: data parallelism on the one card, each leg in processes of its own
   started by torchrun (``python -m torch.distributed.run --standalone``,
   re-entering this script as ``chip_smoke.py --worker <leg> <dir> ...``;
   every rank's exit code and findings file checked). (a) the train CLI on
   ``ema_vqvae.yaml`` at cumulative_bs 32, fp32, TF32 off, cuDNN
   deterministic, one epoch of 4 steps and its validation, under torchrun
   at world 1 on NCCL and again without a group: every logged value but the
   clock's and the final ``state.pt`` bit-identical, B2 once per step, B1 in
   validation. (b) two ranks on card 0 joined by gloo (NCCL refuses two
   ranks on one device; gloo's all-reduce of a CUDA tensor is checked
   first): the ``Trainer`` on ``ema_vqvae.yaml``, fp32, TF32 off, no
   augmentations, 3 steps of 2 x 16 rows of one global batch against one
   process on the 32: each step's reduced EMA counts and ``ema_count``
   equal, ``ema_weight`` and the codebook within ``DDP_EMA_SHARE`` of their
   largest entry, every parameter within AdamW's reach (2 lr x steps), the
   losses within ``DDP_LOSS_RTOL``, the ranks' states bitwise equal, B2
   once per step per rank. (c) two gloo ranks, ``gumbel_vqgan.yaml`` with
   the GAN active and the fused D backward, bf16, 16 rows each: an R1 step,
   then a plain one: finite metrics, R1 > 0 on step 0 only, B3 and B4 on
   every step of every rank, ``check_replication`` after each step. (d)
   the eval CLI on two gloo ranks against one, on (a)'s snapshot, the eval
   phase's ``test.pack`` (64 images) and Inception weights, 24 images per
   rank's batch on both sides (the ranks' global batch 48; each image meets
   the same convolution algorithms): mse / psnr / ssim within
   ``METRIC_RTOL``, usage equal, rFID within
   ``RFID_RTOL``, B1 once per batch per rank. (e) ``standard_vqvae.yaml``
   with a ``loss:`` block without a GAN (LPIPS-AlexNet), full width, bf16,
   3 steps at batch 32 in process: finite, ``perc_loss`` > 0, B1 once per
   step. Times: ms per step of each leg and rank, the gloo all-reduce's
   share of the step.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a visible CUDA device it exits
non-zero before doing anything.
"""

from __future__ import annotations

import collections
import copy
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
from vqvae_tpu_torch.cli import evaluate as cli_evaluate
from vqvae_tpu_torch.cli import tokenize_dataset as cli_tokenize
from vqvae_tpu_torch.cli import train as cli_train
from vqvae_tpu_torch.data.packed import PackedDataset, write_packed
from vqvae_tpu_torch.eval import fid as fid_module
from vqvae_tpu_torch.eval.inception import make_pool3_extractor
from vqvae_tpu_torch.models import quantizers
from vqvae_tpu_torch.models.preprocess import preprocess_batch
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.ops import _build, fused_dbwd, fused_dbwd_cuda, vq_cuda
from vqvae_tpu_torch.ops.upfirdn2d import upfirdn2d
from vqvae_tpu_torch.ops.vq import (code_mismatches, nearest_codes, nearest_codes_reference,
                                    nearest_codes_stats, nearest_codes_stats_reference)
from vqvae_tpu_torch.parallel import dist as pdist
from vqvae_tpu_torch.train import loop
from vqvae_tpu_torch.train.loop import Trainer
from vqvae_tpu_torch.train.native_schedulers import build_native_lr_scheduler
from vqvae_tpu_torch.utils.checkpoint import CheckpointManager
from vqvae_tpu_torch.utils.convert import random_inception_npz
from vqvae_tpu_torch.utils.introspect import check_replication

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "example_confs" / "standard_vqvae.yaml"
TRAIN_CONFIG = ROOT / "example_confs" / "ema_vqvae.yaml"
GAN_CONFIG = ROOT / "example_confs" / "gumbel_vqgan.yaml"
RECIPE_CONFIG = ROOT / "example_confs" / "gumbel_vqgan_1chip.yaml"
ENTROPY_CONFIG = ROOT / "example_confs" / "entropy_vqvae.yaml"
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
EVAL_IMAGES = 64            # the eval phase's test.pack
EVAL_BATCH = 32
TOKENIZE_BATCH = 64         # the token export's batch: M = 64 x 256 latents per B1 launch
METRIC_RTOL = 1e-5          # eval metrics with B1 against the same run with plain argmin
FEATURE_SHARE = 1e-4        # card vs CPU Inception features, share of the largest entry
INCEPTION_IMAGES = 8
ENTROPY_STEPS = ((torch.bfloat16, 4), (torch.float32, 2))
ENTROPY_LOSS_RTOL = 1e-4    # entropy quantizer loss vs its float64 recomputation
DDP_TRAIN_IMAGES = 128      # ddp (a): one epoch of 4 steps of DDP_BATCH
DDP_BATCH = 32              # ddp (a), (b): the global batch
DDP_STEPS = 3               # ddp (b)
DDP_GAN_ROWS = 16           # ddp (c): rows per rank
DDP_EVAL_BATCH = 48         # ddp (d): global on 2 ranks (24 per rank, the last padded)
DDP_EMA_SHARE = 1e-3        # ddp (b): ema_weight, codebook vs one process, share of largest
DDP_LOSS_RTOL = 1e-4        # ddp (b): each step's loss vs one process
RFID_RTOL = 1e-3            # ddp (d): rFID on 2 ranks vs 1 (64 images, 2048-d features)
LPIPS_ALEX_STEPS = 3        # ddp (e)
DDP_TIMEOUT = 600           # s, per process the ddp phase starts
UNTIMED_KEYS = ("time", "train/images_per_sec")   # ddp (a): what two runs cannot share
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


def phase_cli(card: str, device, tmp: Path) -> dict:
    """The port's train CLI in process on the card, in bf16 (its default),
    with torch's default TF32 settings (the CLI's own), on seeded packed data
    written under ``tmp``: legs (a) EMA with accumulation, reinit and resume;
    (b) the published one-chip recipe; (c) the adaptive-lambda GAN with the
    fused D backward. -> this phase's launches per kernel."""
    size = load_config(str(RECIPE_CONFIG)).image_size
    with _tf32(False, True):
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


class _CodeSpy:
    """While it is entered, ``models.quantizers.nearest_codes`` (what every
    quantizer's lookup calls) is ``fn`` wrapped: each call's latents, codebook
    and codes are kept on the card. ``fn`` is the dispatcher itself (B1 on the
    card, which counts its launches) or ``nearest_codes_reference``."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __enter__(self):
        def spy(flat_x, codebook):
            codes = self.fn(flat_x, codebook)
            self.calls.append((flat_x.detach().clone(), codebook.detach(), codes))
            return codes

        self._patch = mock.patch.object(quantizers, "nearest_codes", spy)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()

    def rows(self):
        """-> (latents (M, D), the codebook, codes (M,)) over every call."""
        cb = self.calls[0][1]
        check(all(c[1] is cb or torch.equal(c[1], cb) for c in self.calls),
              "one codebook across the calls")
        return (torch.cat([c[0] for c in self.calls]), cb,
                torch.cat([c[2] for c in self.calls]))


def _evaluate_cli(params: str, data: Path, ckpt: Path):
    """``cli.evaluate.main`` in process on the card, ``evaluate_checkpoint``
    timed on the host clock between synchronisations, and inside it the
    extractor's load and ``FID.compute`` on their own. -> (results, {"eval",
    "load", "compute": seconds})."""
    real_eval, real_compute = cli_evaluate.evaluate_checkpoint, fid_module.FID.compute
    real_load = fid_module.load_inception_extractor
    seen = {}

    def timed_load(*args, **kwargs):
        t0 = time.perf_counter()
        out = real_load(*args, **kwargs)
        torch.cuda.synchronize()
        seen["load"] = time.perf_counter() - t0
        return out

    def timed_eval(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_eval(*args, **kwargs)
        torch.cuda.synchronize()
        seen["eval"] = time.perf_counter() - t0
        return out

    def timed_compute(self):
        t0 = time.perf_counter()
        out = real_compute(self)
        seen["compute"] = time.perf_counter() - t0
        return out

    with mock.patch.object(cli_evaluate, "evaluate_checkpoint", timed_eval), \
            mock.patch.object(fid_module, "load_inception_extractor", timed_load), \
            mock.patch.object(fid_module.FID, "compute", timed_compute):
        results = cli_evaluate.main(["--params_file", params, "--dataloader", "packed",
                                     "--dataset_path", str(data), "--batch_size",
                                     str(EVAL_BATCH), "--seed", str(SEED), "--loading_path",
                                     str(ckpt), "--workers", "4"])
    return results, seen


def _eval_leg(tmp: Path, card: str, device, weights: str) -> int:
    """The eval CLI on the EMA leg's ``last/`` snapshot (ema_vqvae.yaml, N =
    4096) with ``nearest_codes`` forced to its plain version, then as it is
    (B1); the card's Inception against the CPU's. -> B1 launches of the
    second run."""
    params, ckpt = str(tmp / "ema_accum.yaml"), tmp / "ckpt" / "ema" / "last"
    # the plain run first: it pays the fp32 set-up, so the B1 run is timed warm
    _reset_counts()
    with _CodeSpy(nearest_codes_reference) as plain_spy:
        plain, t_cold = _evaluate_cli(params, tmp / "data", ckpt)
    torch.cuda.synchronize()
    check(nearest_codes.launches == 0, "eval with plain argmin: no B1 launch")
    _reset_counts()
    with _CodeSpy(nearest_codes) as spy:
        results, t = _evaluate_cli(params, tmp / "data", ckpt)
    torch.cuda.synchronize()
    b1 = nearest_codes.launches
    batches = EVAL_IMAGES // EVAL_BATCH
    print(f"eval: {{{', '.join(f'{k}: {v:.6f}' for k, v in results.items())}}}; "
          f"nearest_codes launched {b1} times in {batches} eval batches")
    check("rfid" in results and all(math.isfinite(v) for v in results.values()),
          "eval: every metric finite, rFID present")
    check(b1 == batches and nearest_codes_stats.launches == 0,
          f"eval: nearest_codes launched once per eval batch ({batches}), B2 never")
    x, cb, codes = spy.rows()
    x_plain, _, codes_plain = plain_spy.rows()
    check(torch.equal(x, x_plain), "eval: the same latents in both runs")
    _agree(x, cb, codes, codes_plain, f"eval: B1's codes vs plain argmin "
           f"({near_ties(x.contiguous(), cb.contiguous())} near ties rescored)")
    for k in ("mse", "psnr", "ssim"):
        rel = abs(results[k] / plain[k] - 1)
        print(f"eval: {k} with B1 {results[k]!r}, with plain argmin {plain[k]!r} "
              f"(relative gap {rel:.3e}, limit {METRIC_RTOL})")
        check(rel <= METRIC_RTOL, f"eval: {k} with B1 vs with plain argmin")
    for run, got, want in (("B1", results, codes), ("plain", plain, codes_plain)):
        _, perplexity, used = quantizers.get_codebook_usage(torch.bincount(
            want.long(), minlength=cb.shape[0]))
        check(got["used_codebook"] == float(used) and got["perplexity"] == float(perplexity),
              f"eval ({run}): used_codebook and perplexity are the usage of its codes")
    same = torch.equal(codes, codes_plain)
    check(not same or (results["used_codebook"], results["perplexity"])
          == (plain["used_codebook"], plain["perplexity"]),
          "eval: equal codes give equal usage and perplexity")
    print(f"eval: rFID with B1 {results['rfid']!r}, with plain argmin {plain['rfid']!r}; "
          f"codes equal: {same}")
    loop_s = t["eval"] - t["load"] - t["compute"]
    print(f"time [{card}]: eval ema_vqvae.yaml fp32, TF32 off, {EVAL_IMAGES} images at batch "
          f"{EVAL_BATCH}: evaluate_checkpoint with B1 {t['eval']:.3f} s (the second call), "
          f"{EVAL_IMAGES / t['eval']:.1f} images/s: the extractor's load {t['load']:.3f} s, "
          f"FID.compute (two 2048^2 eigh, float64 on the host) {t['compute']:.3f} s, the "
          f"batches (eval steps, metrics, Inception) {loop_s:.3f} s, "
          f"{EVAL_IMAGES / loop_s:.1f} images/s; the first call (plain argmin, fp32 set-up) "
          f"{t_cold['eval']:.3f} s")

    # the card's Inception against the CPU's, TF32 off
    reader = PackedDataset(str(tmp / "data" / "test.pack"))
    images = reader.read_batch(np.arange(EVAL_BATCH))
    reader.close()
    on_card = make_pool3_extractor(weights, device)
    on_cpu = make_pool3_extractor(weights, "cpu")
    got = on_card(images[:INCEPTION_IMAGES])
    want = on_cpu(images[:INCEPTION_IMAGES])
    share = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"eval: Inception pool3 features of {INCEPTION_IMAGES} images, card vs CPU: "
          f"max |diff| {share:.3e} of the largest entry (limit {FEATURE_SHARE})")
    check(share <= FEATURE_SHARE, "eval: the card's Inception features vs the CPU's")
    ms = cuda_ms(lambda: on_card(images), reps=1, windows=3)
    print(f"time [{card}]: Inception (uint8 {images.shape[1]}^2 -> resize 299 -> pool3, fp32, "
          f"TF32 off, features to the host) batch {EVAL_BATCH}: {ms:.2f} ms, "
          f"{EVAL_BATCH * 1000 / ms:.1f} images/s")
    return b1


class _TokenSpy:
    """While it is entered, two CUDA events on the stream around each
    ``VQVAE.get_tokens`` call, no synchronisation between calls; once left,
    ``ms`` holds each call's time and ``n`` its images."""

    def __enter__(self):
        real = VQVAE.get_tokens
        self._events = []

        def get_tokens(model, images, *args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = real(model, images, *args, **kwargs)
            end.record()
            self._events.append((start, end, images.shape[0]))
            return out

        self._patch = mock.patch.object(VQVAE, "get_tokens", get_tokens)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()
        torch.cuda.synchronize()
        self.ms = [start.elapsed_time(end) for start, end, _ in self._events]
        self.n = [n for _, _, n in self._events]


def _tokenize_leg(tmp: Path, card: str, device, config: Path) -> int:
    """The token-export CLI at full width on ``config`` from seeded random
    weights saved as a port snapshot, over the cli phase's train.pack. ->
    B1 launches."""
    name = config.stem
    trainer = Trainer(load_config(str(config)), learning_rate=1e-4, seed=SEED,
                      steps_per_epoch=1, device=device)
    CheckpointManager(str(tmp / "tok_ckpt"), name).save(trainer.init_state(), 0)
    del trainer
    torch.cuda.empty_cache()
    out = tmp / "tokens" / name
    _reset_counts()
    with _CodeSpy(nearest_codes) as spy, _TokenSpy() as timing:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        manifest = cli_tokenize.main(["--params_file", str(config), "--loading_path",
                                      str(tmp / "tok_ckpt" / name / "last"), "--dataset_path",
                                      str(tmp / "data"), "--output_folder", str(out),
                                      "--splits", "train", "--batch_size", str(TOKENIZE_BATCH),
                                      "--dataloader", "packed", "--workers", "4",
                                      "--seed", str(SEED)])
        wall = time.perf_counter() - t0
    b1 = nearest_codes.launches
    n_batches = -(-CLI_TRAIN_IMAGES // TOKENIZE_BATCH)
    check(b1 == n_batches and nearest_codes_stats.launches == 0,
          f"tokenize {name}: nearest_codes launched once per batch ({n_batches}), B2 never")
    tokens = np.load(out / "train_tokens.npy")
    x, cb, codes = spy.rows()
    seq = manifest["latent_tokens"]
    check(tokens.dtype == np.int32 and tokens.shape == (CLI_TRAIN_IMAGES, seq)
          and np.array_equal(tokens, codes.reshape(-1, seq).cpu().numpy()),
          f"tokenize {name}: the .npy holds the tokens B1 picked")
    _agree(x, cb, codes, nearest_codes_reference(x, cb),
           f"tokenize {name}: B1's tokens vs plain fp32 argmin on the card "
           f"({near_ties(x.contiguous(), cb.contiguous())} near ties rescored)")
    steady = statistics.mean(timing.ms[1:])
    print(f"time [{card}]: tokenize {name} fp32, TF32 off, {CLI_TRAIN_IMAGES} images at batch "
          f"{TOKENIZE_BATCH} from train.pack: get_tokens by CUDA events, ms per batch "
          f"{timing.ms[0]:.1f} (first) then mean {steady:.1f}, "
          f"{TOKENIZE_BATCH * 1000 / steady:.1f} images/s; the CLI's wall time {wall:.2f} s (snapshot load, loader and .npy "
          f"included), {CLI_TRAIN_IMAGES / wall:.1f} images/s; nearest_codes launched {b1} "
          f"times; {len(np.unique(tokens))} distinct tokens")
    return b1


class _QuantizerCalls:
    """A forward hook on the quantizer: each train=True call's latents, the
    codebook it used and the loss it returned."""

    def __init__(self, quantizer):
        self.calls = []
        self._handle = quantizer.register_forward_hook(self._post, with_kwargs=True)

    def _post(self, module, args, kwargs, out):
        if kwargs.get("train"):
            self.calls.append((args[0].detach().clone(), module.codebook.weight.detach().clone(),
                               float(out[2])))

    def remove(self):
        self._handle.remove()


def _entropy_steps(card: str, device) -> None:
    """4 bf16 and 2 fp32 full-width entropy_vqvae.yaml train steps at batch
    32 on one fixed batch: finite metrics, each step's quantizer loss equal
    to a float64 recomputation on that step's latents and codebook (the
    distance matmul in true fp32), and no nearest-code kernel (the entropy
    forward takes its codes from the full distance matrix, a library
    matmul, as the JAX package's)."""
    cfg = load_config(str(ENTROPY_CONFIG))
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    size = cfg.image_size
    batch = {"image": torch.rand(TRAIN_BATCH, size, size, 3, device=device, generator=gen)}
    for dtype, n_steps in ENTROPY_STEPS:
        name = str(dtype).removeprefix("torch.")
        trainer = Trainer(cfg, learning_rate=cfg.training.scaled_lr(), seed=SEED,
                          steps_per_epoch=STEPS_PER_EPOCH, compute_dtype=dtype, device=device)
        state = trainer.init_state()
        spy = _QuantizerCalls(state.model.quantizer)
        _reset_counts()
        history = [{k: float(v) for k, v in trainer.train_step(state, batch, epoch=0)[1].items()}
                   for _ in range(n_steps)]
        spy.remove()
        check(nearest_codes.launches == 0 and nearest_codes_stats.launches == 0,
              f"entropy {name}: the train steps launch no nearest-code kernel")
        check(all(math.isfinite(v) for m in history for v in m.values()),
              f"entropy {name}: every metric finite")
        q64 = copy.deepcopy(state.model.quantizer).double()
        gaps = []
        for z, cb, loss in spy.calls:
            with torch.no_grad():
                q64.codebook.weight.copy_(cb)
                want = float(q64(z.double(), train=True)[2])
            gaps.append(abs(loss / want - 1))
        print(f"entropy slice {name}: {n_steps} steps at batch {TRAIN_BATCH}, loss "
              + " ".join(f"{m['loss']:.5f}" for m in history) + "; quant_loss "
              + " ".join(f"{m['quant_loss']:.5f}" for m in history) + "; l2_loss "
              + " ".join(f"{m['l2_loss']:.5f}" for m in history)
              + f"; usage {int((state.usage_count > 0).sum())} codes used; each step's "
              f"quantizer loss vs float64 on its latents: relative gap "
              + " ".join(f"{g:.2e}" for g in gaps) + f" (limit {ENTROPY_LOSS_RTOL})")
        check(len(gaps) == n_steps and max(gaps) <= ENTROPY_LOSS_RTOL,
              f"entropy {name}: the quantizer loss equals its float64 recomputation")
        ms = cuda_ms(lambda: trainer.train_step(state, batch, epoch=0), reps=1, windows=3)
        print(f"time [{card}]: train_step entropy {name} batch {TRAIN_BATCH}: {ms:.2f} ms, "
              f"{TRAIN_BATCH * 1000 / ms:.1f} images/s")
        del trainer, state, spy, q64
        torch.cuda.empty_cache()


def phase_eval(card: str, device, tmp: Path) -> dict:
    """The eval and token-export CLIs in process on the card, on the cli
    phase's packs and snapshots under ``tmp`` plus a seeded test.pack and
    seeded Inception weights, then the entropy quantizer's train steps.
    -> this phase's B1 launches, by leg."""
    size = load_config(str(TRAIN_CONFIG)).image_size
    rs = np.random.RandomState(SEED + 11)
    write_packed(str(tmp / "data" / "test.pack"),
                 (rs.randint(0, 256, (size, size, 3), dtype=np.uint8)
                  for _ in range(EVAL_IMAGES)), size)
    weights = random_inception_npz(tmp / "inception_fid.npz", seed=SEED + 12)
    with mock.patch.dict(os.environ, {"VQVAE_TPU_INCEPTION_WEIGHTS": weights}):
        launches = {"eval": _eval_leg(tmp, card, device, weights)}
    torch.cuda.empty_cache()
    for config in (CONFIG, ENTROPY_CONFIG):
        launches[f"tokenize {config.stem}"] = _tokenize_leg(tmp, card, device, config)
        torch.cuda.empty_cache()
    _entropy_steps(card, device)
    return launches


def _run_quiet(cmd: list, what: str, env=None) -> None:
    """Run ``cmd`` from the checkout's root in a session of its own, at most
    ``DDP_TIMEOUT`` s (its whole process group is killed past that); a
    non-zero exit ends the script, after the tail of its output."""
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True, env=env)
    try:
        out, _ = proc.communicate(timeout=DDP_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        check(False, f"{what}: no end within {DDP_TIMEOUT} s")
    if proc.returncode != 0:
        print(out[-6000:])
    check(proc.returncode == 0, f"{what}: exit code {proc.returncode}")


def _torchrun(nproc: int, leg: str, out: Path, *args) -> list:
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc chip_smoke.py --worker leg out args``: torchrun exits non-zero if
    any rank does; each rank leaves ``out/rank<r>.pt``. -> those, by rank."""
    out.mkdir(parents=True, exist_ok=True)
    # every rank is on this host: gloo and NCCL open their sockets on loopback
    env = {"GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "lo", **os.environ}
    _run_quiet([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(nproc), str(Path(__file__).resolve()), "--worker", leg,
                str(out), *args], f"ddp ({leg}) on {nproc} ranks", env=env)
    files = [out / f"rank{r}.pt" for r in range(nproc)]
    check(all(f.is_file() for f in files), f"ddp ({leg}): every rank wrote its findings")
    return [torch.load(f, weights_only=False) for f in files]


class _AllReduceTimer:
    """While it is entered, each ``torch.distributed.all_reduce`` is timed on
    the host clock between two synchronisations of the card."""

    def __init__(self):
        self.seconds, self.calls = 0.0, 0

    def __enter__(self):
        real = torch.distributed.all_reduce

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        self._patch = mock.patch.object(torch.distributed, "all_reduce", timed)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def _timed_steps(trainer, state, images, epoch: int, n: int):
    """``n`` train steps on ``images``, each timed between synchronisations,
    with the gloo all-reduces inside them timed apart. -> (state, metrics per
    step, ms per step, all-reduce ms per step, B3/B4 launches per step)."""
    history, ms, reduce_ms, dbwd = [], [], [], []
    for _ in range(n):
        before = _dbwd_counts()
        with _AllReduceTimer() as timer:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, {"image": images}, epoch=epoch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        reduce_ms.append(timer.seconds * 1e3)
        after = _dbwd_counts()
        dbwd.append((after[0] - before[0], after[1] - before[1]))
        history.append({k: float(v) for k, v in metrics.items()})
    return state, history, ms, reduce_ms, dbwd


def _ddp_ema_run(device) -> dict:
    """Leg (b)'s steps on this process's rows of one global batch:
    ``ema_vqvae.yaml`` at full width, fp32, no augmentations, DDP_STEPS
    steps. Records the EMA counts each step applies (after the reduction
    over the ranks) and the model's final state."""
    cfg = load_config(str(TRAIN_CONFIG))
    rank, world = pdist.world()
    size = cfg.image_size
    images = np.random.RandomState(SEED + 13).rand(DDP_BATCH, size, size, 3).astype(np.float32)
    per = DDP_BATCH // world
    trainer = Trainer(cfg, learning_rate=cfg.training.scaled_lr(), seed=SEED,
                      steps_per_epoch=STEPS_PER_EPOCH, compute_dtype=torch.float32,
                      augment=False, device=device)
    state = trainer.init_state()
    replicas = {"model": state.model, "usage_count": state.usage_count}
    check_replication(replicas)
    counts = []
    real_reduce = quantizers.all_reduce_sum_

    def spy(tensors):
        real_reduce(tensors)
        counts.append(tensors[0].detach().cpu().clone())

    _reset_counts()
    with mock.patch.object(quantizers, "all_reduce_sum_", spy):
        state, history, ms, reduce_ms, _ = _timed_steps(
            trainer, state, images[rank * per:(rank + 1) * per], 0, DDP_STEPS)
    b1, b2 = nearest_codes.launches, nearest_codes_stats.launches
    check_replication(replicas)
    return {"rank": rank, "world": world, "metrics": history, "ms": ms, "reduce_ms": reduce_ms,
            "counts": counts, "b1": b1, "b2": b2, "per": per,
            "state": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}}


def _ddp_gan_run(device) -> dict:
    """Leg (c)'s steps: ``gumbel_vqgan.yaml`` with the GAN active, the fused
    D backward, bf16, this rank's 16 rows: an R1 step, then a plain one,
    the replicas checked after each."""
    cfg = load_config(str(GAN_CONFIG))
    rank, world = pdist.world()
    size = cfg.image_size
    images = np.random.RandomState(SEED + 15).rand(DDP_GAN_ROWS * world, size, size,
                                                   3).astype(np.float32)
    epoch = cfg.loss.adversarial.start_epoch
    trainer = Trainer(cfg, learning_rate=cfg.training.scaled_lr(), seed=SEED,
                      steps_per_epoch=STEPS_PER_EPOCH, compute_dtype=torch.bfloat16,
                      device=device, fused_dbwd=True, fused_skip=True)
    state = trainer.init_state()
    replicas = {"model": state.model, "disc": state.disc, "usage_count": state.usage_count}
    check_replication(replicas)
    _reset_counts()
    history, ms, reduce_ms, dbwd = [], [], [], []
    for _ in range(2):
        state, h, m, r, d = _timed_steps(
            trainer, state, images[rank * DDP_GAN_ROWS:(rank + 1) * DDP_GAN_ROWS], epoch, 1)
        check_replication(replicas)
        history += h
        ms += m
        reduce_ms += r
        dbwd += d
    return {"rank": rank, "metrics": history, "ms": ms, "reduce_ms": reduce_ms, "dbwd": dbwd,
            "b1": nearest_codes.launches, "b2": nearest_codes_stats.launches,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _ddp_worker(leg: str, out: Path, argv: list) -> None:
    """One rank of a ddp leg, started by torchrun (leg (a)'s run without a
    group: alone). TF32 off. Leg ``train`` (a) runs the train CLI with
    cuDNN's deterministic algorithms, so that two runs can agree bit for
    bit; the others join a gloo group on card 0 (two ranks share the one
    card, which NCCL refuses) after checking gloo's all-reduce of a CUDA
    tensor. Writes ``out/rank<r>.pt``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if leg == "train":
        torch.backends.cudnn.deterministic = True
        seen = {}
        real_run = loop.run_training

        def run_training(*args, **kwargs):
            seen["world"] = pdist.world()
            seen["backend"] = (torch.distributed.get_backend()
                               if torch.distributed.is_initialized() else None)
            return real_run(*args, **kwargs)

        _reset_counts()
        with mock.patch.object(loop, "run_training", run_training), _StepSpy() as spy:
            cli_train.main(argv)
        torch.cuda.synchronize()
        torch.save({**seen, "b1": nearest_codes.launches, "b2": nearest_codes_stats.launches,
                    "ms": [t for t, _, _ in spy.steps]}, out / "rank0.pt")
        return
    pdist.init_distributed("cuda", backend="gloo", local_rank=0)
    try:
        rank, world = pdist.world()
        probe = torch.full((4,), float(rank + 1), device=pdist.default_device())
        torch.distributed.all_reduce(probe)
        check(bool((probe == world * (world + 1) / 2).all()),
              "gloo's all_reduce of a CUDA tensor sums over the ranks")
        if leg == "ema":
            found = _ddp_ema_run(pdist.default_device())
        elif leg == "gan":
            found = _ddp_gan_run(pdist.default_device())
        elif leg == "eval":
            calls = []
            real_eval = loop.Trainer.eval_step

            def eval_step(*args, **kwargs):
                calls.append(1)
                return real_eval(*args, **kwargs)

            _reset_counts()
            with mock.patch.object(loop.Trainer, "eval_step", eval_step):
                results = cli_evaluate.main(argv)
            found = {"rank": rank, "results": results, "batches": len(calls),
                     "b1": nearest_codes.launches}
        else:
            raise ValueError(f"unknown ddp leg {leg!r}")
        torch.save({**found, "backend": torch.distributed.get_backend()},
                   out / f"rank{rank}.pt")
    finally:
        pdist.shutdown()


def _same_payload(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_payload(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same_payload(x, y) for x, y in zip(a, b)))
    return a == b


def _ddp_leg_nccl(tmp: Path, card: str) -> dict:
    """Leg (a): the train CLI under torchrun, world 1 on NCCL, against the
    same run without a group: ema_vqvae.yaml at full width, fp32, TF32 off,
    cumulative_bs 32, one epoch of 4 steps and its validation."""
    params = _yaml(tmp / "ema_ddp.yaml", TRAIN_CONFIG, lambda raw: raw["training"].update(
        cumulative_bs=DDP_BATCH, grad_accum_steps=1))
    args = ["--params_file", params, "--dataloader", "packed", "--dataset_path",
            str(tmp / "ddp_data"), "--save_path", str(tmp / "ddp_ckpt"), "--seed", str(SEED),
            "--workers", "4", "--precision", "fp32", "--max_epochs", "1"]
    t0 = time.perf_counter()
    (nccl,) = _torchrun(1, "train", tmp / "ddp_a_nccl", *args, "--run_name", "nccl")
    t_nccl = time.perf_counter() - t0
    (tmp / "ddp_a_plain").mkdir()
    t0 = time.perf_counter()
    _run_quiet([sys.executable, str(Path(__file__).resolve()), "--worker", "train",
                str(tmp / "ddp_a_plain"), *args, "--run_name", "plain"],
               "ddp (a) without a group")
    t_plain = time.perf_counter() - t0
    plain = torch.load(tmp / "ddp_a_plain" / "rank0.pt", weights_only=False)
    check(nccl["world"] == (0, 1) and nccl["backend"] == "nccl",
          f"ddp (a): torchrun's world of 1 on NCCL ({nccl['world']}, {nccl['backend']})")
    check(plain["world"] == (0, 1) and plain["backend"] is None, "ddp (a): no group alone")
    runs = tmp / "ddp_ckpt"
    logged = [[{k: v for k, v in r.items() if k not in UNTIMED_KEYS}
               for r in _records(runs / name)] for name in ("nccl", "plain")]
    check(len(logged[0]) > 0 and logged[0] == logged[1],
          "ddp (a): every logged value of the NCCL world-1 run equals the run without a group")
    states = [torch.load(runs / name / "last" / "state.pt", map_location="cpu",
                         weights_only=True) for name in ("nccl", "plain")]
    same_bytes = ((runs / "nccl" / "last" / "state.pt").read_bytes()
                  == (runs / "plain" / "last" / "state.pt").read_bytes())
    check(_same_payload(*states), "ddp (a): the final state.pt of the two runs are bit-identical")
    steps = len(nccl["ms"])
    check(steps == DDP_TRAIN_IMAGES // DDP_BATCH and nccl["b2"] == plain["b2"] == steps,
          f"ddp (a): B2 once per step ({nccl['b2']}, {plain['b2']} for {steps} steps)")
    check(nccl["b1"] > 0 and nccl["b1"] == plain["b1"], "ddp (a): B1 in validation")
    print(f"ddp (a) [{card}]: train CLI, ema_vqvae.yaml fp32, TF32 off, cuDNN deterministic, "
          f"1 x {DDP_BATCH}: torchrun world 1 on NCCL vs no group: {len(logged[0])} logged "
          f"records equal (all keys but {', '.join(UNTIMED_KEYS)}), final state.pt tensors "
          f"equal (file bytes {'equal' if same_bytes else 'differ'}); launches B2 "
          f"{nccl['b2']} / {plain['b2']}, B1 {nccl['b1']} / {plain['b1']}; ms per step NCCL "
          + " ".join(f"{t:.1f}" for t in nccl["ms"]) + ", no group "
          + " ".join(f"{t:.1f}" for t in plain["ms"])
          + f"; process wall time {t_nccl:.1f} / {t_plain:.1f} s")
    return {"nearest_codes": nccl["b1"] + plain["b1"],
            "nearest_codes_stats": nccl["b2"] + plain["b2"]}


def _share(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |b|."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp(min=1e-30))


def _ddp_leg_ema(tmp: Path, card: str, device) -> dict:
    """Leg (b): 2 gloo ranks x 16 against one process x 32 on the same
    global batch, through the Trainer."""
    ranks = _torchrun(2, "ema", tmp / "ddp_b")
    one = _ddp_ema_run(device)
    for r in ranks:
        check(r["backend"] == "gloo" and r["world"] == 2 and r["per"] == DDP_BATCH // 2,
              "ddp (b): two gloo ranks of 16")
        check(r["b2"] == DDP_STEPS and r["b1"] == 0,
              f"ddp (b): rank {r['rank']}: B2 once per step ({r['b2']}), no B1")
        check(len(r["counts"]) == DDP_STEPS and all(
            torch.equal(c, w) for c, w in zip(r["counts"], one["counts"])),
            f"ddp (b): rank {r['rank']}: each step's EMA counts equal one process's")
        check(all(math.isfinite(v) for m in r["metrics"] for v in m.values()),
              "ddp (b): every metric finite")
    r0, r1 = ranks
    check(all(torch.equal(r0["state"][k], r1["state"][k]) for k in r0["state"]),
          "ddp (b): the two ranks' final states are bitwise equal")
    q = "quantizer."
    check(torch.equal(r0["state"][q + "ema_count"], one["state"][q + "ema_count"]),
          "ddp (b): ema_count equals one process's exactly")
    params = {k: _share(v, one["state"][k]) for k, v in r0["state"].items()
              if not k.startswith(q)}
    lr = load_config(str(TRAIN_CONFIG)).training.scaled_lr()
    reach = max(float((v - one["state"][k]).abs().max()) for k, v in r0["state"].items()
                if not k.startswith(q))
    ema_share = _share(r0["state"][q + "ema_weight"], one["state"][q + "ema_weight"])
    cb_share = _share(r0["state"][q + "codebook.weight"], one["state"][q + "codebook.weight"])
    loss_gap = max(abs(a["loss"] / b["loss"] - 1) for a, b in zip(r0["metrics"], one["metrics"]))
    worst = max(params, key=params.get)
    print(f"ddp (b) [{card}]: Trainer ema_vqvae.yaml fp32, TF32 off, {DDP_STEPS} steps, "
          f"2 gloo ranks x {r0['per']} on one card vs 1 x {DDP_BATCH}: EMA counts equal every "
          f"step, ema_count "
          f"equal; ema_weight {ema_share:.3g}, codebook {cb_share:.3g} of their largest entry; "
          f"parameters: worst {worst} {params[worst]:.3g} of its largest entry, largest "
          f"|difference| {reach:.3g} (AdamW's reach {2 * lr * DDP_STEPS:.3g} = 2 lr x steps); "
          f"loss relative gap {loss_gap:.3g}")
    check(ema_share <= DDP_EMA_SHARE and cb_share <= DDP_EMA_SHARE,
          f"ddp (b): ema_weight and codebook within {DDP_EMA_SHARE} of their largest entry")
    check(reach <= 2 * lr * DDP_STEPS, "ddp (b): every parameter within AdamW's reach")
    check(loss_gap <= DDP_LOSS_RTOL, f"ddp (b): losses within {DDP_LOSS_RTOL}")
    for r in ranks:
        steady = statistics.mean(r["ms"][1:])
        share = sum(r["reduce_ms"][1:]) / sum(r["ms"][1:])
        print(f"time [{card}]: ddp (b) rank {r['rank']}, 2 ranks x {r['per']} on one card, "
              f"fp32: ms "
              f"per step " + " ".join(f"{t:.1f}" for t in r["ms"]) + f" (gloo all-reduce "
              + " ".join(f"{t:.1f}" for t in r["reduce_ms"]) + f"); steps 2-{DDP_STEPS}: "
              f"{steady:.1f} ms, all-reduce share {share:.3f}")
    print(f"time [{card}]: ddp (b) one process x {DDP_BATCH}, fp32: ms per step "
          + " ".join(f"{t:.1f}" for t in one["ms"]))
    return {"nearest_codes_stats": sum(r["b2"] for r in ranks)}


def _ddp_leg_gan(tmp: Path, card: str) -> dict:
    """Leg (c): 2 gloo ranks, gumbel_vqgan.yaml with the GAN active and the
    fused D backward, 16 per rank, bf16: an R1 step, then a plain one."""
    ranks = _torchrun(2, "gan", tmp / "ddp_c")
    for r in ranks:
        name = f"ddp (c): rank {r['rank']}"
        r1 = [m["r1_penalty"] for m in r["metrics"]]
        check(all(math.isfinite(v) for m in r["metrics"] for v in m.values()),
              f"{name}: every metric finite")
        check(r1[0] > 0 and r1[1] == 0, f"{name}: r1_penalty > 0 on step 0 only ({r1})")
        check(all(b3 > 0 and b4 > 0 for b3, b4 in r["dbwd"]),
              f"{name}: B3 and B4 launched on every step ({r['dbwd']})")
        check(r["b1"] == 0 and r["b2"] == 0, f"{name}: no nearest-code kernel")
        print(f"time [{card}]: ddp (c) rank {r['rank']}, 2 gloo ranks x {DDP_GAN_ROWS} on one "
              f"card, gumbel_vqgan.yaml bf16, fused D backward: ms per step (R1, plain) "
              + " ".join(f"{t:.1f}" for t in r["ms"]) + "; gloo all-reduce "
              + " ".join(f"{t:.1f}" for t in r["reduce_ms"]) + f" (share of the plain step "
              f"{r['reduce_ms'][1] / r['ms'][1]:.3f}); B3/B4 launches per step {r['dbwd']}; "
              f"loss {[round(m['loss'], 5) for m in r['metrics']]}, r1_penalty "
              f"{[round(v, 6) for v in r1]}; peak memory {r['peak_gib']:.2f} GiB")
    check(ranks[0]["metrics"] == ranks[1]["metrics"],
          "ddp (c): both ranks log the same (rank-averaged) metrics")
    return {"blur_t_gate": sum(b3 for r in ranks for b3, _ in r["dbwd"]),
            "skip_fanout_bwd": sum(b4 for r in ranks for _, b4 in r["dbwd"])}


def _ddp_leg_eval(tmp: Path, card: str) -> dict:
    """Leg (d): the eval CLI on 2 gloo ranks against 1, on leg (a)'s
    snapshot and the eval phase's test.pack and Inception weights, at
    DDP_EVAL_BATCH / 2 images per rank's batch on both sides (each rank's
    last batch padded), so that each image meets the same convolution
    algorithms in both runs."""
    per_batch = DDP_EVAL_BATCH // 2
    args = ["--params_file", str(tmp / "ema_ddp.yaml"), "--dataloader", "packed",
            "--dataset_path", str(tmp / "data"), "--seed", str(SEED), "--loading_path",
            str(tmp / "ddp_ckpt" / "plain" / "last"), "--workers", "4"]
    env = {"VQVAE_TPU_INCEPTION_WEIGHTS": str(tmp / "inception_fid.npz")}
    with mock.patch.dict(os.environ, env):
        t0 = time.perf_counter()
        ranks = _torchrun(2, "eval", tmp / "ddp_d", *args, "--batch_size", str(DDP_EVAL_BATCH))
        t_two = time.perf_counter() - t0
        _reset_counts()
        t0 = time.perf_counter()
        want = cli_evaluate.main(args + ["--batch_size", str(per_batch)])
        t_one = time.perf_counter() - t0
    one_b1 = nearest_codes.launches
    per_rank = -(-EVAL_IMAGES // 2)
    n_batches = -(-per_rank // per_batch)
    gaps = {}
    for r in ranks:
        got = r["results"]
        check(got.keys() == want.keys() and "rfid" in got, "ddp (d): the same metrics, rFID too")
        check(all(math.isfinite(v) for v in got.values()), "ddp (d): every metric finite")
        for k in ("mse", "psnr", "ssim"):
            check(abs(got[k] / want[k] - 1) <= METRIC_RTOL,
                  f"ddp (d): {k} within {METRIC_RTOL} of one rank's")
        check(got["used_codebook"] == want["used_codebook"]
              and got["perplexity"] == want["perplexity"], "ddp (d): usage equal to one rank's")
        gaps[r["rank"]] = abs(got["rfid"] / want["rfid"] - 1)
        check(gaps[r["rank"]] <= RFID_RTOL, f"ddp (d): rFID within {RFID_RTOL} of one rank's")
        check(r["batches"] == n_batches and r["b1"] == n_batches,
              f"ddp (d): rank {r['rank']}: B1 once per batch ({r['b1']} for {r['batches']})")
    print(f"ddp (d) [{card}]: eval CLI, 2 gloo ranks x {per_batch} vs 1 x {per_batch} on "
          f"{EVAL_IMAGES} images ({n_batches} batches per rank, the last padded): one rank "
          f"{want}; 2 ranks: {ranks[0]['results']}; rFID relative gap "
          f"{max(gaps.values()):.3g} (limit {RFID_RTOL}); B1 per rank "
          f"{[r['b1'] for r in ranks]}, one rank {one_b1}; wall time 2 ranks {t_two:.1f} s "
          f"(process start included), one rank in process {t_one:.1f} s")
    return {"nearest_codes": sum(r["b1"] for r in ranks) + one_b1}


def _lpips_alex_leg(tmp: Path, card: str, device) -> dict:
    """Leg (e): standard_vqvae.yaml with a ``loss:`` block without a GAN
    (LPIPS-AlexNet, seeded random weights unless converted ones are
    present), full width, bf16, LPIPS_ALEX_STEPS steps at batch 32."""
    cfg = load_config(_yaml(tmp / "alex.yaml", CONFIG, lambda raw: raw.update(loss={
        "l1_weight": 0.8, "l2_weight": 0.2, "perc_weight": 1.0})))
    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    size = cfg.image_size
    images = torch.rand(TRAIN_BATCH, size, size, 3, device=device, generator=gen)
    trainer = Trainer(cfg, learning_rate=cfg.training.scaled_lr(), seed=SEED,
                      steps_per_epoch=STEPS_PER_EPOCH, compute_dtype=torch.bfloat16,
                      device=device)
    check(type(trainer.losses.lpips.net).__name__ == "AlexNetFeatures",
          "lpips-alex: a loss: block without a GAN takes LPIPS-AlexNet")
    state = trainer.init_state()
    _reset_counts()
    state, history, ms, _, _ = _timed_steps(trainer, state, images, 0, LPIPS_ALEX_STEPS)
    b1 = nearest_codes.launches
    check(all(math.isfinite(v) for m in history for v in m.values())
          and all(m["perc_loss"] > 0 for m in history),
          "lpips-alex: every metric finite, perc_loss > 0")
    check(b1 == LPIPS_ALEX_STEPS and nearest_codes_stats.launches == 0,
          f"lpips-alex: B1 once per step ({b1})")
    print(f"time [{card}]: ddp (e) lpips-alex, standard_vqvae.yaml + loss block, bf16, batch "
          f"{TRAIN_BATCH}: ms per step " + " ".join(f"{t:.1f}" for t in ms) + "; loss "
          + " ".join(f"{m['loss']:.5f}" for m in history) + "; perc_loss "
          + " ".join(f"{m['perc_loss']:.5f}" for m in history) + f"; B1 launched {b1} times")
    return {"nearest_codes": b1}


def phase_ddp(card: str, device, tmp: Path) -> dict:
    """Data parallelism on the one card: (a) the train CLI under torchrun at
    world 1 on NCCL against no group; (b) the EMA Trainer on 2 gloo ranks
    against one process; (c) the GAN on 2 gloo ranks; (d) the eval CLI on 2
    gloo ranks against 1; (e) LPIPS-AlexNet training in process. Needs the
    eval phase's test.pack and Inception weights under ``tmp``. -> this
    phase's launches per kernel (every rank's)."""
    torch.cuda.empty_cache()   # the ranks are other processes on this card
    size = load_config(str(TRAIN_CONFIG)).image_size
    _write_packs(tmp / "ddp_data", DDP_TRAIN_IMAGES, CLI_VAL_IMAGES, size, SEED + 14)
    launches = collections.Counter()
    for leg, fn in (("a", lambda: _ddp_leg_nccl(tmp, card)),
                    ("b", lambda: _ddp_leg_ema(tmp, card, device)),
                    ("c", lambda: _ddp_leg_gan(tmp, card)),
                    ("d", lambda: _ddp_leg_eval(tmp, card)),
                    ("e", lambda: _lpips_alex_leg(tmp, card, device))):
        t0 = time.perf_counter()
        found = fn()
        launches.update(found)
        torch.cuda.empty_cache()
        print(f"time [{card}]: ddp ({leg}) took {time.perf_counter() - t0:.1f} s; launches "
              f"{dict(found)}")
    return dict(launches)


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
    if sys.argv[1:2] == ["--worker"]:   # one rank of a ddp leg (phase_ddp starts it)
        _ddp_worker(sys.argv[2], Path(sys.argv[3]), sys.argv[4:])
        return
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as name:
        tmp = Path(name)
        t_cli = time.perf_counter()
        cli = phase_cli(card, device, tmp)
        print(f"time [{card}]: cli: the phase took {time.perf_counter() - t_cli:.1f} s; "
              f"launches {cli}")
        t_eval = time.perf_counter()
        evals = phase_eval(card, device, tmp)
        b1_eval = sum(evals.values())
        print(f"time [{card}]: eval: the phase took {time.perf_counter() - t_eval:.1f} s; "
              f"nearest_codes launches {evals}, {b1_eval} in all")
        t_ddp = time.perf_counter()
        ddp = phase_ddp(card, device, tmp)
        print(f"time [{card}]: ddp: the phase took {time.perf_counter() - t_ddp:.1f} s; "
              f"launches, every rank's {ddp}")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [
        # launches: the tokenizer path's, the training path's, the train
        # CLI's (cli_launches: the last alone, counted from 0 for each of its
        # legs), the eval and token-export CLIs' (eval_launches) and the ddp
        # phase's, every rank's (ddp_launches); max_abs_err:
        # the largest float64 score gap between the kernel's and the plain
        # version's pick over every compared row (0.0 where all agree)
        # bound_ms: 3 TF32 passes x 2MND on the tensor cores (bound_ops; the
        # FFMA bound is in the time lines); device_ms: the kernels' device
        # time (profiler), ms: CUDA events around the wrapper
        _record("nearest_codes", "vqvae_tpu_torch/csrc/nearest_codes.cu",
                "vqvae_tpu/ops/vq_pallas.py:141",
                b1_tokenizer + b1_train + cli["nearest_codes"] + b1_eval
                + ddp.get("nearest_codes", 0),
                max(kernel_gap, slice_gap), (8192, 1024, 256), b1) | _scan_bound(b1)
        | {"cli_launches": cli["nearest_codes"], "eval_launches": b1_eval,
           "ddp_launches": ddp.get("nearest_codes", 0)},
        # max_abs_err: the largest |dw - dw_plain| over the compared shapes
        _record("nearest_codes_stats", "vqvae_tpu_torch/csrc/nearest_codes_stats.cu",
                "vqvae_tpu/ops/vq_pallas.py:89",
                b2_train + cli["nearest_codes_stats"] + ddp.get("nearest_codes_stats", 0),
                stats_err, STATS_SHAPES[0], b2) | _scan_bound(b2)
        | {"cli_launches": cli["nearest_codes_stats"],
           "ddp_launches": ddp.get("nearest_codes_stats", 0)},
        # launches: the GAN path's 8 train steps and the CLI's leg (c); max_abs_err: the largest
        # |kernel - plain| over every compared shape, fp32 and bf16 (bf16 is
        # one bf16 ulp); times at the first block's shape in bf16, the
        # training compute dtype
        _record("blur_t_gate", "vqvae_tpu_torch/csrc/fused_dbwd.cu",
                "vqvae_tpu/ops/fused_dbwd.py:220",
                b3_gan + cli["blur_t_gate"] + ddp.get("blur_t_gate", 0), b3_err, b256,
                dbwd[("B3", torch.bfloat16, b256)])
        | {"dtype": "bfloat16", "cli_launches": cli["blur_t_gate"],
           "ddp_launches": ddp.get("blur_t_gate", 0)},
        _record("skip_fanout_bwd", "vqvae_tpu_torch/csrc/fused_dbwd.cu",
                "vqvae_tpu/ops/fused_dbwd.py:386",
                b4_gan + cli["skip_fanout_bwd"] + ddp.get("skip_fanout_bwd", 0), b4_err, b256,
                dbwd[("B4", torch.bfloat16, b256)])
        | {"dtype": "bfloat16", "cli_launches": cli["skip_fanout_bwd"],
           "ddp_launches": ddp.get("skip_fanout_bwd", 0)},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
