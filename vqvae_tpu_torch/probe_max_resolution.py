"""The resolution one card can tokenize (counterpart of
``tools/probe_max_resolution.py``).

    python -m vqvae_tpu_torch.probe_max_resolution [--channels 128] [--start 256]
        [--max 16384] [--dtype fp32|bf16] [--device cuda|cpu]

Runs ``get_tokens`` on one image (batch 1) at doubling resolutions until a
call fails (``torch.cuda.OutOfMemoryError``, or another ``RuntimeError`` of
a size a library refuses) or ``--max`` is passed, on ``standard_vqvae.yaml``'s tokenizer (channel multipliers
[1, 2, 2, 4], two residual blocks per level, N = 1024, D = 256, so that the
nearest-code kernel runs on the latents) at ``--channels`` width with seeded
random weights and a seeded random image: the memory depends on neither. fp32 runs with
TF32 off, the token-export CLI's precision. ``parallel/spatial.py`` takes an
image past this ceiling by splitting its height over several cards.

One line per resolution: the time of a second call (CUDA events; the host
clock with ``--device cpu``), the peak memory allocated during it (``not
measured`` on the CPU), the JAX tool's estimate (``activation_estimate_gb``:
four bf16 tensors at full resolution) and the port's own
(``port_estimate_gb``); then the largest resolution that fit.
``main(argv)`` runs in process and returns a record per resolution tried.
"""

from __future__ import annotations

import argparse
import time

SEED = 0


def activation_estimate_gb(res: int, channels: int) -> float:
    """The JAX tool's estimate of the encoder's peak live set: ~4 bf16
    tensors of ``res^2 x channels`` at full resolution."""
    return 4 * res * res * channels * 2 / 1e9


def port_estimate_gb(res: int, channels: int, dtype: str) -> float:
    """The port's estimate: the peak lies in a first-level GroupNorm, whose
    statistics are fp32 whatever the compute dtype. It holds the block's
    input and four fp32 tensors of its size (centred, normalized, scaled,
    shifted): 5 fp32 tensors of ``res^2 x channels`` in fp32; in bf16 the
    input, its fp32 copy and the four."""
    n = res * res * channels
    return (5 * 4 * n if dtype == "fp32" else (2 + 5 * 4) * n) / 1e9


def raw_config(res: int, channels: int) -> dict:
    return {
        "image_size": res,
        "autoencoder": {"channels": channels, "num_res_blocks": 2,
                        "channel_multipliers": [1, 2, 2, 4]},
        "quantizer": {"num_embeddings": 1024, "embedding_dim": 256, "type": "standard",
                      "reinit_every_n_epochs": None, "params": {"commitment_cost": 0.25}},
        "training": {"cumulative_bs": 8, "base_lr": 1e-4, "betas": [0.0, 0.99], "eps": 1e-8,
                     "weight_decay": 0.0, "decay_epochs": 1, "max_epochs": 1},
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--start", type=int, default=256)
    ap.add_argument("--max", type=int, default=16384)
    ap.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"],
                    help="compute dtype (fp32: TF32 off)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run; cuda needs a visible card")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)

    import torch

    from vqvae_tpu_torch.config import parse_config
    from vqvae_tpu_torch.models.vqvae import VQVAE
    from vqvae_tpu_torch.utils.precision import set_full_fp32

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible "
                           "(pass --device cpu to run on the CPU)")
    set_full_fp32()
    device = torch.device(args.device)
    dtype = torch.float32 if args.dtype == "fp32" else torch.bfloat16
    # the weights do not depend on the resolution: one model for every size
    model = VQVAE.from_config(parse_config(raw_config(args.start, args.channels)), dtype=dtype,
                              device=device, generator=torch.Generator().manual_seed(SEED))

    def timed(x) -> float:
        """ms of one ``get_tokens`` call (synchronised)."""
        if not on_card:
            t0 = time.perf_counter()
            model.get_tokens(x)
            return (time.perf_counter() - t0) * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        model.get_tokens(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    rows, last_ok, res = [], None, args.start
    while res <= args.max:
        row = {"res": res, "jax_estimate_gb": activation_estimate_gb(res, args.channels),
               "port_estimate_gb": port_estimate_gb(res, args.channels, args.dtype)}
        try:
            x = torch.rand(1, res, res, 3, device=device,
                           generator=torch.Generator(device=device).manual_seed(SEED + 1))
            tokens = model.get_tokens(x)   # first call: cuDNN's choices, the allocator
            if on_card:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            row["ms"] = timed(x)
            row["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None
            row["tokens"] = tuple(tokens.shape)
            row["ok"] = True
        except RuntimeError as exc:   # OutOfMemoryError, or a size a library refuses
            row.update(ok=False, error=f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}")
        x = tokens = None
        if on_card:
            torch.cuda.empty_cache()
        rows.append(row)
        peak = "not measured" if row.get("peak_gb") is None else f"{row['peak_gb']:.2f} GB"
        print(f"res={res}: " + (f"OK tokens={row['tokens']} {row['ms']:.1f} ms, peak {peak}"
                                if row["ok"] else f"FAIL {row['error']}")
              + f"; estimate JAX {row['jax_estimate_gb']:.2f} GB, port {args.dtype} "
              f"{row['port_estimate_gb']:.2f} GB", flush=True)
        if not row["ok"]:
            break
        last_ok = res
        res *= 2
    where = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"single-card tokenization ceiling (batch 1, channels {args.channels}, {args.dtype}, "
          f"{where}): {last_ok}")
    return rows


if __name__ == "__main__":
    main()
