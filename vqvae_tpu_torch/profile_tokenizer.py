"""Where the device time of the tokenizer API goes, on one CUDA card.

    python -m vqvae_tpu_torch.profile_tokenizer

Builds ``VQVAE`` from ``example_confs/standard_vqvae.yaml`` at full width
with seeded random weights, in fp32 and in bf16, with TF32 off as in
``chip_smoke.py``. For each of ``get_tokens``, ``reconstruct_from_tokens``
and ``reconstruct`` at batch ``BATCH`` it makes ``WARMUP`` calls, then
records ``CALLS`` calls in one ``torch.profiler`` window. Per call it prints:

- ``window``: the time between two CUDA events around the window;
- ``kernels``: the summed device time of every kernel, memcpy and memset
  the profiler saw in the window (one stream, so they do not overlap);
- ``idle``: ``1 - kernels / window``, the share of the window the card was
  idle, with the profiler on;
- the kernel time by kind (``KINDS``, matched on the kernel's name), then
  the ``TOP`` kernels by time.

Times are per call (window / ``CALLS``). The first line is the card's
name and power limit from ``nvidia-smi``.
"""

from __future__ import annotations

import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

CONFIG = Path(__file__).resolve().parent.parent / "example_confs" / "standard_vqvae.yaml"
SEED = 0
BATCH = 32
WARMUP = 2
CALLS = 3
TOP = 10

# (kind, substrings of the kernel name); the first kind that matches wins
KINDS = (
    ("B1 nearest_codes", ("nearest_codes",)),
    ("conv fft", ("fft", "pointwise_mult_and_sum_complex")),
    ("conv layout", ("nchwtonhwc", "nhwctonchw")),
    ("conv gemm", ("xmma", "gemm", "cudnn", "conv", "cutlass")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "copy")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def device_events(prof) -> list:
    """The window's device-side events: kernels, memcpys and memsets."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_call(fn):
    """-> (window ms, {kernel name: (count, total ms)}) for ``CALLS`` calls."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        torch.cuda.synchronize()
    per_kernel = defaultdict(lambda: [0, 0.0])
    for e in device_events(prof):
        per_kernel[e.name][0] += 1
        per_kernel[e.name][1] += e.time_range.elapsed_us() / 1000
    return start.elapsed_time(end), dict(per_kernel)


def report(label: str, window_ms: float, per_kernel: dict, card: str) -> None:
    by_kind = defaultdict(float)
    for name, (_, ms) in per_kernel.items():
        by_kind[kind_of(name)] += ms / CALLS
    kernels = sum(by_kind.values())
    window = window_ms / CALLS
    kinds = ", ".join(f"{k} {ms:.2f} ms" for k, ms in sorted(by_kind.items(),
                                                             key=lambda kv: -kv[1]))
    print(f"== {label} [{card}]: window {window:.2f} ms/call, kernels {kernels:.2f} ms/call, "
          f"idle {1 - kernels / window:.3f}; {kinds}")
    for name, (count, ms) in sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:TOP]:
        print(f"  {ms / CALLS:9.2f} ms {count // CALLS:4d}x  {kind_of(name):16s} {name[:110]}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("profile_tokenizer: no CUDA device is visible")

    from vqvae_tpu_torch import VQVAE, load_config

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cfg = load_config(str(CONFIG))
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    size = cfg.image_size
    images = torch.rand(BATCH, size, size, 3, device=device, generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        model = VQVAE.from_config(cfg, dtype=dtype, device=device,
                                  generator=torch.Generator().manual_seed(SEED))
        tokens = model.get_tokens(images)
        for name, fn in (("get_tokens", lambda: model.get_tokens(images)),
                         ("reconstruct_from_tokens",
                          lambda: model.reconstruct_from_tokens(tokens)),
                         ("reconstruct", lambda: model.reconstruct(images))):
            window_ms, per_kernel = profile_call(fn)
            report(f"{name} {str(dtype).removeprefix('torch.')} batch {BATCH}",
                   window_ms, per_kernel, card)


if __name__ == "__main__":
    main()
