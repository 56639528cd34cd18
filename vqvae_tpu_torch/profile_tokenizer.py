"""Where the device time of the tokenizer API, the EMA training step and the
GAN training step goes, on one CUDA card.

    python -m vqvae_tpu_torch.profile_tokenizer [all | tokenizer | ema | gan]

Builds ``VQVAE`` from ``example_confs/standard_vqvae.yaml`` and ``Trainer``s
from ``example_confs/ema_vqvae.yaml`` and ``example_confs/gumbel_vqgan.yaml``
at full width with seeded random weights, in fp32 and in bf16, with TF32 off
as in ``chip_smoke.py``. For each of ``get_tokens``,
``reconstruct_from_tokens``, ``reconstruct`` and ``train_step``
(augmentations on, as ``train.py`` runs it; the GAN step at
``epoch=start_epoch``, R1 and not, with the fused D backward and without)
at batch ``BATCH`` it makes ``WARMUP`` calls, then records ``CALLS`` calls
in one ``torch.profiler`` window. Kernel names do not say which module
launched a convolution, so the GAN step's two loss networks are also
profiled alone at the step's shapes: LPIPS-VGG's forward on both images
and backward to the reconstructions, and the discriminator's first-order
forward and backward passes of a non-R1 step. Per call it prints:

- ``window``: the time between two CUDA events around the window;
- ``kernels``: the summed device time of every kernel, memcpy and memset
  the profiler saw in the window;
- ``busy``: the time at least one of them ran (cuDNN's backward runs some
  kernels side by side on streams of its own, so ``kernels`` can exceed it);
- ``idle``: ``1 - busy / window``, the share of the window the card was
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

CONFIGS = Path(__file__).resolve().parent.parent / "example_confs"
CONFIG = CONFIGS / "standard_vqvae.yaml"
TRAIN_CONFIG = CONFIGS / "ema_vqvae.yaml"
GAN_CONFIG = CONFIGS / "gumbel_vqgan.yaml"
SEED = 0
BATCH = 32
WARMUP = 2
CALLS = 3
TOP = 10

# (kind, substrings of the kernel name); the first kind that matches wins
KINDS = (
    ("B3 blur_t_gate", ("blur_t_gate",)),
    ("B4 skip_fanout_bwd", ("skip_fanout_bwd",)),
    ("B2 nearest_codes_stats", ("nearest_codes_stats",)),
    ("B1 nearest_codes", ("nearest_codes",)),
    ("optimizer", ("multi_tensor_apply", "adam")),
    ("conv wgrad", ("wgrad",)),
    ("conv dgrad", ("dgrad",)),
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


def busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit / 1000."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1000


def profile_call(fn):
    """-> (window ms, busy ms, {kernel name: (count, total ms)}) for
    ``CALLS`` calls."""
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
    events = device_events(prof)
    for e in events:
        per_kernel[e.name][0] += 1
        per_kernel[e.name][1] += e.time_range.elapsed_us() / 1000
    busy = busy_ms((e.time_range.start, e.time_range.end) for e in events)
    return start.elapsed_time(end), busy, dict(per_kernel)


def report(label: str, window_ms: float, busy: float, per_kernel: dict, card: str) -> None:
    by_kind = defaultdict(float)
    for name, (_, ms) in per_kernel.items():
        by_kind[kind_of(name)] += ms / CALLS
    kernels = sum(by_kind.values())
    window = window_ms / CALLS
    busy /= CALLS
    kinds = ", ".join(f"{k} {ms:.2f} ms" for k, ms in sorted(by_kind.items(),
                                                             key=lambda kv: -kv[1]))
    print(f"== {label} [{card}]: window {window:.2f} ms/call, kernels {kernels:.2f} ms/call, "
          f"busy {busy:.2f} ms/call, idle {1 - busy / window:.3f}; {kinds}")
    for name, (count, ms) in sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:TOP]:
        print(f"  {ms / CALLS:9.2f} ms {count // CALLS:4d}x  {kind_of(name):16s} {name[:110]}")


def profile_gan(device, card: str) -> None:
    """The GAN step on gumbel_vqgan.yaml, then its LPIPS and D alone."""
    from vqvae_tpu_torch import load_config
    from vqvae_tpu_torch.train.loop import Trainer

    cfg = load_config(str(GAN_CONFIG))
    epoch = cfg.loss.adversarial.start_epoch
    size = cfg.image_size
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    batch = {"image": torch.rand(BATCH, size, size, 3, device=device, generator=gen)}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        trainer = Trainer(cfg, learning_rate=cfg.training.scaled_lr(), seed=SEED,
                          steps_per_epoch=1000, compute_dtype=dtype, device=device,
                          fused_dbwd=True, fused_skip=True)
        state = trainer.init_state()
        for r1, fused in ((False, True), (False, False), (True, True)):
            def step():
                state.disc.set_fused(fused, fused)
                trainer.host_step = 0 if r1 else 1
                trainer.train_step(state, batch, epoch=epoch)
            label = (f"train_step gan {'R1' if r1 else 'non-R1'} "
                     f"{'fused' if fused else 'plain'} D backward {name} batch {BATCH}")
            report(label, *profile_call(step), card)
        state.disc.set_fused(True, True)

        images = (batch["image"] * 2 - 1).detach()
        recon = images.flip(0).clone()

        def lpips_call():
            y = recon.clone().requires_grad_(True)
            trainer.losses.lpips(images, y).backward()

        report(f"LPIPS-VGG forward x2 + backward {name} batch {BATCH}",
               *profile_call(lpips_call), card)
        real = images.permute(0, 3, 1, 2).contiguous()
        fake = recon.permute(0, 3, 1, 2).contiguous()
        d_params = list(state.disc.parameters())

        def disc_call():
            x = fake.clone().requires_grad_(True)
            logits = state.disc(x)
            logits.sum().backward(inputs=d_params, retain_graph=True)
            logits.sum().backward(inputs=[x])
            state.disc(real).sum().backward(inputs=d_params)

        report(f"D first-order: fake forward + 2 backward, real forward + backward, "
               f"fused, {name} batch {BATCH}", *profile_call(disc_call), card)
        del trainer, state
        torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("profile_tokenizer: no CUDA device is visible")
    what = sys.argv[1] if len(sys.argv) > 1 else "all"
    if what not in ("all", "tokenizer", "ema", "gan"):
        sys.exit(f"profile_tokenizer: unknown part {what!r}: all | tokenizer | ema | gan")

    from vqvae_tpu_torch import VQVAE, load_config
    from vqvae_tpu_torch.train.loop import Trainer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    if what in ("all", "gan"):
        profile_gan(device, card)
    if what == "gan":
        return
    cfg = load_config(str(CONFIG))
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    size = cfg.image_size
    images = torch.rand(BATCH, size, size, 3, device=device, generator=gen)
    for dtype in (torch.float32, torch.bfloat16) if what in ("all", "tokenizer") else ():
        model = VQVAE.from_config(cfg, dtype=dtype, device=device,
                                  generator=torch.Generator().manual_seed(SEED))
        tokens = model.get_tokens(images)
        for name, fn in (("get_tokens", lambda: model.get_tokens(images)),
                         ("reconstruct_from_tokens",
                          lambda: model.reconstruct_from_tokens(tokens)),
                         ("reconstruct", lambda: model.reconstruct(images))):
            report(f"{name} {str(dtype).removeprefix('torch.')} batch {BATCH}",
                   *profile_call(fn), card)
        del model

    train_cfg = load_config(str(TRAIN_CONFIG))
    batch = {"image": torch.rand(BATCH, size, size, 3, device=device, generator=gen)}
    for dtype in (torch.float32, torch.bfloat16) if what in ("all", "ema") else ():
        trainer = Trainer(train_cfg, learning_rate=train_cfg.training.scaled_lr(), seed=SEED,
                          steps_per_epoch=1000, compute_dtype=dtype, device=device)
        state = trainer.init_state()
        report(f"train_step ema {str(dtype).removeprefix('torch.')} batch {BATCH}",
               *profile_call(lambda: trainer.train_step(state, batch, epoch=0)), card)
        del state


if __name__ == "__main__":
    main()
