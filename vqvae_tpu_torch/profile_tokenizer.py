"""Where the device time of the tokenizer API, the EMA training step and the
GAN training step goes, on one CUDA card.

    python -m vqvae_tpu_torch.profile_tokenizer [all | tokenizer | ema | gan] [--remat 0|1|auto]
    python -m vqvae_tpu_torch.profile_tokenizer step [mse | lpips | gan | gan_r1] [--remat ...]
    python -m vqvae_tpu_torch.profile_tokenizer r1 [--remat ...]

Builds ``VQVAE`` from ``example_confs/standard_vqvae.yaml`` and ``Trainer``s
from ``example_confs/ema_vqvae.yaml`` and ``example_confs/gumbel_vqgan.yaml``
at full width with seeded random weights, in fp32 and in bf16, with TF32 off
as in ``chip_smoke.py``. For each of ``get_tokens``,
``reconstruct_from_tokens``, ``reconstruct`` and ``train_step``
(augmentations on, as ``train.py`` runs it; the GAN step at
``epoch=start_epoch``, R1 and not, with the fused D backward and without)
at batch ``BATCH`` it makes ``WARMUP`` calls, then records ``CALLS`` calls
in one ``torch.profiler`` window. Per call it prints:

- ``window``: the time between two CUDA events around the window;
- ``kernels``: the summed device time of every kernel, memcpy and memset
  the profiler saw in the window;
- ``busy``: the time at least one of them ran (cuDNN's backward runs some
  kernels side by side on streams of its own, so ``kernels`` can exceed it);
- ``idle``: ``1 - busy / window``, the share of the window the card was
  idle, with the profiler on;
- the kernel time by kind (``KINDS``, matched on the kernel's name), then
  the ``TOP`` kernels by time;
- for the train steps (the GAN part and the ``step`` part), the device
  time by span, from the window's span log (``utils/introspect``): each
  span path (``train.step/gan.d_real_backward``, ...), its device ms and
  its count per call. Kernel names do not say which module launched a
  convolution; the spans do.

Times are per call (window / ``CALLS``). The first line is the card's
name and power limit from ``nvidia-smi``. ``--remat`` is every profiled
Trainer's ``remat`` (``bench_breakdown.remat_arg``); the default ``0`` is
the JAX tool's (``tools/profile_step.py:117-122``).

The ``step`` part (counterpart of ``tools/profile_step.py``) profiles the
train step of one variant of ``bench_breakdown`` (default ``gan_r1``) at
batch ``BATCH`` in bf16, built by its ``make_cfg``, with the discriminator's
plain backward (the JAX Trainer's default), through the same
``profile_call`` / ``report``. R1 runs when the Trainer's host step is a
multiple of ``r1_reg_every``; ``step_window_start`` sets the host step so
that the first step of the window is one (the JAX tool profiles host steps
3-6, which hold no R1 step), and the part prints which window step took R1.

The ``r1`` part profiles one R1 step and one plain step of the bf16 GAN
Trainer on gumbel_vqgan.yaml (plain D backward, after one warm step of
each kind) with the operators' input shapes, and splits each step's kernel
time by ``composite``: the autograd node whose backward launched the
kernel, and, inside autograd's generic convolution double backward, its
batch-1 per-channel convolutions, its convolutions with an image-sized
weight operand, and the rest.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from collections import defaultdict
from pathlib import Path
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile

from vqvae_tpu_torch.utils.introspect import span_log

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


def report_spans(spans: list, calls: int = CALLS) -> None:
    """Device ms and count per call of each span path of the window's span
    log (``introspect.span_log()``), in the order they first open; nothing
    where the log does not hold ``calls`` calls."""
    if sum(s["parent"] is None for s in spans) != calls:
        print("  (no span log of this window)")
        return
    paths, totals = {}, {}
    for s in spans:   # a parent comes before its children
        parent = s["parent"]
        paths[s["index"]] = s["name"] if parent is None else f"{paths[parent]}/{s['name']}"
        total = totals.setdefault(paths[s["index"]], [0, 0.0])
        total[0] += 1
        total[1] += s["device_ms"]
    for path, (count, ms) in totals.items():
        print(f"  {ms / calls:9.2f} ms {count / calls:5.1f}x  span {path}")


CONV_OPS = ("aten::_convolution", "aten::convolution", "aten::cudnn_convolution")
DOUBLE_BACKWARD = "aten::_convolution_double_backward"
NODE = "autograd::engine::evaluate_function: "


def composite(event) -> str:
    """The composite whose work a CPU operator event's kernels are: inside
    ``DOUBLE_BACKWARD``, by its innermost convolution's operands (a batch of
    1, a weight wider than 4 x 4, or neither); else the innermost autograd
    node evaluated around it; else ``forward``."""
    chain = []
    while event is not None:
        chain.append(event)
        event = event.cpu_parent
    names = [e.name for e in chain]
    if DOUBLE_BACKWARD in names:
        conv = next((e for e in chain if e.name in CONV_OPS and len(e.input_shapes) > 1), None)
        if conv is not None and conv.input_shapes[0][:1] == [1]:
            return "double backward: batch-1 per-channel convs"
        if conv is not None and max(conv.input_shapes[1][2:], default=0) > 4:
            return "double backward: image-sized weight convs"
        return "double backward: rest"
    return next((n[len(NODE):] for n in names if n.startswith(NODE)), "forward")


def composite_split(prof) -> dict:
    """{composite: (kernel count, device ms)} of a profile's kernels."""
    split = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        for k in e.kernels:
            total = split[composite(e)]
            total[0] += 1
            total[1] += k.duration / 1000
    return dict(split)


def _gan_inputs(device):
    """gumbel_vqgan.yaml's config, the epoch its GAN starts at, and one
    seeded batch of ``BATCH`` images."""
    from vqvae_tpu_torch import load_config

    cfg = load_config(str(GAN_CONFIG))
    size = cfg.image_size
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    batch = {"image": torch.rand(BATCH, size, size, 3, device=device, generator=gen)}
    return cfg, cfg.loss.adversarial.start_epoch, batch


def profile_r1(device, card: str, remat: Optional[bool] = False) -> None:
    """One R1 step and one plain step of the bf16 GAN step, by composite."""
    from vqvae_tpu_torch.train.loop import Trainer

    cfg, epoch, batch = _gan_inputs(device)
    trainer = Trainer(cfg, learning_rate=cfg.training.scaled_lr(), seed=SEED,
                      steps_per_epoch=1000, compute_dtype=torch.bfloat16, device=device,
                      remat=remat)
    state = trainer.init_state()

    def step(r1: bool):
        trainer.host_step = 0 if r1 else 1
        trainer.train_step(state, batch, epoch=epoch)

    for r1 in (True, False):
        step(r1)
    torch.cuda.synchronize()
    for r1 in (True, False):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            start.record()
            step(r1)
            end.record()
            torch.cuda.synchronize()
        split = composite_split(prof)
        print(f"== train_step gan {'R1' if r1 else 'non-R1'} plain D backward bfloat16 batch "
              f"{BATCH} [{card}]: window {start.elapsed_time(end):.2f} ms, kernels "
              f"{sum(ms for _, ms in split.values()):.2f} ms; by composite:")
        for name, (count, ms) in sorted(split.items(), key=lambda kv: -kv[1][1]):
            print(f"  {ms:9.2f} ms {count:6d}x  {name}")
        report_spans(span_log(), calls=1)


def profile_gan(device, card: str, remat: Optional[bool] = False) -> None:
    """The GAN step on gumbel_vqgan.yaml: kernels, then device time by span."""
    from vqvae_tpu_torch.train.loop import Trainer

    cfg, epoch, batch = _gan_inputs(device)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        trainer = Trainer(cfg, learning_rate=cfg.training.scaled_lr(), seed=SEED,
                          steps_per_epoch=1000, compute_dtype=dtype, device=device,
                          fused_dbwd=True, fused_skip=True, remat=remat)
        state = trainer.init_state()
        for r1, fused in ((False, True), (False, False), (True, True)):
            def step():
                state.disc.set_fused(fused, fused)
                trainer.host_step = 0 if r1 else 1
                trainer.train_step(state, batch, epoch=epoch)
            label = (f"train_step gan {'R1' if r1 else 'non-R1'} "
                     f"{'fused' if fused else 'plain'} D backward {name} batch {BATCH}")
            report(label, *profile_call(step), card)
            report_spans(span_log())
        del trainer, state
        torch.cuda.empty_cache()


def step_window_start(r1_every: int) -> int:
    """The host step to set before ``profile_call``'s ``WARMUP`` calls so that
    the first call of its window is an R1 step."""
    return r1_every - WARMUP % r1_every


def profile_step(variant: str, device, card: str, remat: Optional[bool] = False) -> list:
    """The train step of ``bench_breakdown``'s ``variant`` (bf16, batch
    ``BATCH``, plain D backward, the Trainer's ``remat``), profiled. ->
    whether each call of the window took R1."""
    from vqvae_tpu_torch.bench_breakdown import VARIANTS, make_cfg
    from vqvae_tpu_torch.train.loop import Trainer

    cfg = make_cfg(256, 128, **VARIANTS[variant])
    trainer = Trainer(cfg=cfg, learning_rate=1e-4, seed=SEED, steps_per_epoch=1000,
                      compute_dtype=torch.bfloat16, device=device, remat=remat)
    state = trainer.init_state()
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    size = cfg.image_size
    batch = {"image": torch.randint(0, 256, (BATCH, size, size, 3), dtype=torch.uint8,
                                    device=device, generator=gen)}
    if cfg.use_adversarial and cfg.loss.adversarial.r1_reg_weight is not None:
        trainer.host_step = step_window_start(cfg.loss.adversarial.r1_reg_every)
    took_r1 = []

    def step():
        took_r1.append(trainer.r1_due(0))
        trainer.train_step(state, batch, epoch=0)

    timings = profile_call(step)
    window = took_r1[WARMUP:]
    report(f"train_step {variant} bf16 batch {BATCH}, plain D backward, remat "
           f"{trainer.remat}; R1 on window call"
           f"{'s' if sum(window) != 1 else ''} "
           + (", ".join(str(i + 1) for i, r in enumerate(window) if r) or "none")
           + f" of {CALLS}", *timings, card)
    report_spans(span_log())
    del trainer, state
    torch.cuda.empty_cache()
    return window


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("part", nargs="?", default="all",
                    choices=["all", "tokenizer", "ema", "gan", "step", "r1"])
    ap.add_argument("variant", nargs="?", default="gan_r1",
                    help="the step part's bench_breakdown variant: mse | lpips | gan | gan_r1")
    ap.add_argument("--remat", default="0", choices=["0", "1", "auto"],
                    help="the profiled Trainers' remat: off, on, or their own decision")
    return ap.parse_args(argv)


def main(argv=None):
    """Runs the part ``argv`` names; -> the ``step`` part's window R1 flags."""
    from vqvae_tpu_torch import VQVAE, load_config
    from vqvae_tpu_torch.bench_breakdown import VARIANTS, remat_arg
    from vqvae_tpu_torch.train.loop import Trainer

    args = parse_args(argv)
    what, remat = args.part, remat_arg(args.remat)
    if not torch.cuda.is_available():
        sys.exit("profile_tokenizer: no CUDA device is visible")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    if what == "step":
        if args.variant not in VARIANTS:
            sys.exit(f"profile_tokenizer: unknown variant {args.variant!r}: "
                     f"{' | '.join(VARIANTS)}")
        return profile_step(args.variant, device, card, remat)
    if what == "r1":
        return profile_r1(device, card, remat)
    if what in ("all", "gan"):
        profile_gan(device, card, remat)
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
                          steps_per_epoch=1000, compute_dtype=dtype, device=device,
                          remat=remat)
        state = trainer.init_state()
        report(f"train_step ema {str(dtype).removeprefix('torch.')} batch {BATCH}",
               *profile_call(lambda: trainer.train_step(state, batch, epoch=0)), card)
        del state


if __name__ == "__main__":
    main()
