"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit (nvcc). It builds the port's kernels from ``vqvae_tpu_torch/csrc``
into ``vqvae_tpu_torch/_build/``, then runs five phases; a failure in any of
them ends the script with a non-zero exit and no result line:

1. device: card name and power limit (nvidia-smi); TF32 off for matmuls and
   convolutions, so that fp32 means fp32;
2. build: the time nvcc takes;
3. kernel vs plain: the nearest-code kernel against
   ``nearest_codes_reference`` at the tokenizer's shapes and at ragged ones;
4. slice: the tokenizer API (``get_tokens``, ``reconstruct``,
   ``reconstruct_from_tokens``) at full width on
   ``example_confs/standard_vqvae.yaml`` with seeded random weights, at
   batch 1, 8 and 32, counting kernel launches;
5. times: CUDA events, warm-up, median of 5 windows.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a visible CUDA device it exits
non-zero before doing anything.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from vqvae_tpu_torch import load_config
from vqvae_tpu_torch.models.preprocess import preprocess_batch
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.ops import _build, vq_cuda
from vqvae_tpu_torch.ops.vq import code_mismatches, nearest_codes, nearest_codes_reference

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "example_confs" / "standard_vqvae.yaml"
SEED = 0
KERNEL_SHAPES = [(8192, 1024, 256), (256, 1024, 256), (1000, 37, 8), (4097, 1024, 256)]
MISMATCH_SHARE = 1e-4       # at most 0.01% of rows may differ, each a near-tie
RECON_ATOL = 1e-4           # reconstruct_from_tokens(get_tokens(x)) vs reconstruct(x)
BATCHES = (1, 8, 32)
TIMED_BATCH = 32


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


def phase_build() -> None:
    so = _build.library_path("nearest_codes")
    fresh = not so.exists()
    t0 = time.perf_counter()
    vq_cuda.library()
    print(f"build: nearest_codes.cu {'built' if fresh else 'found built'} in "
          f"{time.perf_counter() - t0:.2f} s -> {so.relative_to(ROOT)}")


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
    # a duplicated codebook row ties exactly: the first index wins; a NaN
    # latent row maps to code 0 as torch.argmin does
    cb = torch.randn(1024, 256, device=device, generator=gen)
    cb[700] = cb[300]
    x = torch.randn(512, 256, device=device, generator=gen)
    x[:256] = cb[300]
    x[300, 5] = float("nan")
    got = vq_cuda.nearest_codes_cuda(x, cb)
    want = nearest_codes_reference(x, cb)
    check(bool((got[:256] == 300).all()), "duplicated row: the first index wins")
    check(int(got[300]) == 0 and torch.equal(got, want), "NaN row and ties as the plain version")
    print("kernel vs plain: duplicated codebook row -> first index (256 of 256 rows); "
          "NaN row -> code 0; equal to the plain version on all 512 rows")
    return max_gap


def phase_slice(cfg, device):
    model = VQVAE.from_config(cfg, device=device,
                              generator=torch.Generator().manual_seed(SEED))
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    size = cfg.image_size
    batches = {b: torch.rand(b, size, size, 3, device=device, generator=gen) for b in BATCHES}

    nearest_codes.launches = 0
    outputs = {}
    for b, images in batches.items():
        tokens = model.get_tokens(images)
        recon = model.reconstruct(images)
        outputs[b] = (tokens, recon, model.reconstruct_from_tokens(tokens))
    torch.cuda.synchronize()
    launches = nearest_codes.launches
    print(f"slice: {2 * len(BATCHES)} tokenizer calls launched the nearest_codes kernel "
          f"{launches} times")
    # one launch per get_tokens and one per reconstruct, at every batch size
    check(launches == 2 * len(BATCHES),
          f"the main path launched the nearest_codes kernel {2 * len(BATCHES)} times")

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
                                          f"slice b={b}: get_tokens vs plain on the latents"))
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


def phase_times(cfg, model, device, card: str):
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    x = torch.randn(8192, 256, device=device, generator=gen)
    cb = torch.randn(1024, 256, device=device, generator=gen)
    # plain, kernel, kernel, plain: both sides see the same card state
    plain, kernel = [], []
    for side in (plain, kernel, kernel, plain):
        fn = (lambda: nearest_codes_reference(x, cb)) if side is plain else (
            lambda: vq_cuda.nearest_codes_cuda(x, cb))
        side.append(cuda_ms(fn, reps=50))
    kernel_ms, plain_ms = statistics.mean(kernel), statistics.mean(plain)
    print(f"time [{card}]: nearest_codes (8192,1024,256) kernel {kernel_ms:.4f} ms "
          f"(windows {kernel[0]:.4f}, {kernel[1]:.4f}), plain matmul+argmin {plain_ms:.4f} ms "
          f"(windows {plain[0]:.4f}, {plain[1]:.4f})")

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
    return kernel_ms, plain_ms


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is visible; this script runs only on a GPU")
    device = torch.device("cuda", 0)
    card = phase_device()
    phase_build()
    kernel_gap = phase_kernel(device)
    cfg = load_config(str(CONFIG))
    model, launches, slice_gap = phase_slice(cfg, device)
    kernel_ms, plain_ms = phase_times(cfg, model, device, card)
    print(json.dumps({"kernels": [{
        "name": "nearest_codes",
        "route": "cuda",
        "source": "vqvae_tpu_torch/csrc/nearest_codes.cu",
        "replaces": "vqvae_tpu/ops/vq_pallas.py:141",
        "launches": launches,
        # largest float64 score gap between the kernel's and the plain
        # version's pick over every compared row (0.0 where all agree)
        "max_abs_err": max(kernel_gap, slice_gap),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
