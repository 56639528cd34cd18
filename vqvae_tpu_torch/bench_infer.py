"""Serving throughput of the tokenizer API on one card (counterpart of
``tools/bench_infer.py``).

    python -m vqvae_tpu_torch.bench_infer [--device cuda|cpu] [--dtype bf16|fp32]

The reference's inference surface (reference model.py:458-489), as stage-2
models and serving call it, timed at full width on the 256^2 gumbel VQGAN
with seeded random weights:

  - tokenize     ``get_tokens(deterministic=True)``: [0,1] images -> (B, S) codes
  - reconstruct  ``reconstruct``: [0,1] images -> [0,1] images
  - detokenize   ``reconstruct_from_tokens``: (B, S) codes -> [0,1] images

The images and tokens are made on the device first (host input is not
timed). Each rate is the batch times the calls of a window over the
window's time, median of 3 windows after a warm-up call: on the card the
window lies between two CUDA events; on the CPU (``--device cpu``, a small
config as the JAX tool takes on the CPU) it is the host clock. Compute in
bf16 by default, as the JAX tool; ``--dtype fp32`` runs fp32 with TF32 off,
the token-export CLI's precision. The gumbel tokens are an argmax of the
encoder's channels: no nearest-code kernel runs here.

Prints one JSON line: the JAX tool's keys (``metric``, ``batch``,
``tokenize_ips``, ``reconstruct_ips``, ``detokenize_ips``) plus ``dtype``,
``device`` (the card's name, or ``cpu``) and ``card`` (``nvidia-smi``'s name
and power limit; null on the CPU). Env knobs: ``VQGAN_INFER_BATCH`` (default
32 on the card, 8 on the CPU), ``VQGAN_INFER_STEPS`` (calls per window,
default 16). ``main(argv)`` runs in process and returns the record.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

METRIC = "inference images/sec/chip, 256^2 gumbel VQGAN tokenizer API"
SEED = 0
WINDOWS = 3


def raw_config(on_card: bool) -> dict:
    """The JAX tool's config: the 256^2 gumbel VQGAN on the card, a small
    one on the CPU."""
    return {
        "image_size": 256 if on_card else 32,
        "autoencoder": {"channels": 128 if on_card else 32, "num_res_blocks": 2,
                        "channel_multipliers": [1, 2, 2, 4] if on_card else [1, 2]},
        "quantizer": {"num_embeddings": 1024 if on_card else 64,
                      "embedding_dim": 256 if on_card else 16,
                      "type": "gumbel", "reinit_every_n_epochs": None,
                      "params": {"straight_through": False, "temp": 1.0,
                                 "kl_cost": 0.00859375, "kl_warmup_epochs": 0.48,
                                 "temp_decay_epochs": 15, "temp_final": 0.0625}},
        "training": {"cumulative_bs": 256, "base_lr": 1e-4, "betas": [0.0, 0.99],
                     "eps": 1e-8, "weight_decay": 1e-4, "decay_epochs": 250,
                     "max_epochs": 300},
    }


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def window_seconds(fn, calls: int, device) -> float:
    """Seconds of ``calls`` calls of ``fn``: CUDA events on the card, the
    host clock on the CPU."""
    import torch
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return time.perf_counter() - t0


def images_per_second(fn, batch: int, calls: int, device) -> float:
    fn()   # warm-up: cuDNN's algorithm choice, the allocator's first blocks
    return batch * calls / statistics.median(
        window_seconds(fn, calls, device) for _ in range(WINDOWS))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run; cuda needs a visible card")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"],
                    help="compute dtype (fp32: TF32 off)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    import torch

    from vqvae_tpu_torch.config import parse_config
    from vqvae_tpu_torch.models.vqvae import VQVAE
    from vqvae_tpu_torch.utils.precision import set_full_fp32

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible "
                           "(pass --device cpu to run on the CPU)")
    if args.dtype == "fp32":
        set_full_fp32()
    device = torch.device(args.device)
    batch = int(os.environ.get("VQGAN_INFER_BATCH", 32 if on_card else 8))
    calls = int(os.environ.get("VQGAN_INFER_STEPS", 16))
    cfg = parse_config(raw_config(on_card))
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model = VQVAE.from_config(cfg, dtype=dtype, device=device,
                              generator=torch.Generator().manual_seed(SEED))
    size = cfg.image_size
    images = torch.rand(batch, size, size, 3, device=device,
                        generator=torch.Generator(device=device).manual_seed(SEED + 1))
    tokens = model.get_tokens(images, deterministic=True)

    record = {
        "metric": METRIC,
        "batch": batch,
        "tokenize_ips": images_per_second(
            lambda: model.get_tokens(images, deterministic=True), batch, calls, device),
        "reconstruct_ips": images_per_second(lambda: model.reconstruct(images), batch, calls,
                                             device),
        "detokenize_ips": images_per_second(lambda: model.reconstruct_from_tokens(tokens),
                                            batch, calls, device),
        "dtype": str(dtype).removeprefix("torch."),
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "card": card_line() if on_card else None,
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
