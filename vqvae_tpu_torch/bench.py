"""The headline benchmark: train images/sec/chip of 256^2 gumbel-VQGAN
training (counterpart of the repo-root ``bench.py``).

    python -m vqvae_tpu_torch.bench [--device cuda|cpu]
    python -m vqvae_tpu_torch.bench --leg NAME [--device cuda|cpu]

The flagship leg is the published gumbel-VQGAN recipe at full width
(``flagship_raw``: 256^2, channels 128, multipliers [1, 2, 2, 4], N 1024,
D 256, LPIPS-VGG and the StyleGAN2 D from epoch 0, non-saturating, R1 of
weight 10 every 16 steps) at ``cumulative_bs`` 256, taken on one card as
``VQGAN_BENCH_ACCUM`` (default 8) micro-batches of ``VQGAN_BENCH_BATCH``
(default 32), with seeded random weights. With ``--device cpu`` it is the
JAX tool's small CPU config (32^2, channels 32, [1, 2], N 64, D 16, batch
8, no accumulation). Four secondary legs run on the card only, each at
batch 32 without accumulation: ``ema_vqvae``, ``standard_vqvae`` and
``entropy_vqvae`` (the flagship's dict without ``loss:``, the quantizer
swapped) and ``gan_b32_plain`` (the flagship's step without accumulation;
only when ``VQGAN_BENCH_ACCUM`` > 1).

Each leg builds ``Trainer(cfg, learning_rate=1e-4, seed=0,
steps_per_epoch=1000, compute_dtype=torch.bfloat16)`` on one seeded uint8
batch staged on the device once (host input is not timed), makes 3 warm-up
steps at epoch 0 (host step 0 is R1), then 3 windows of 16 steps
(``time_windows``). A window runs on the host clock from before its first
step to a ``torch.cuda.synchronize`` and a fetch of its last loss, with no
synchronisation inside it; it covers host steps 3-18, 19-34 and 35-50, so
each holds one R1 step (16, 32, 48). The value is the batch x 16 over the
median window. The flagship's ``remat`` is ``VQGAN_BENCH_REMAT`` (``0``
off, the default; ``1`` on; ``auto`` the Trainer's own decision), the
secondary legs' off. ``VQVAE_TPU_FUSED_DBWD`` / ``VQVAE_TPU_FUSED_SKIP``
set to ``1`` send the D's first-order backward through the kernels B3 /
B4 in the GAN legs, as in the train CLI (``fused_backward_from_env``);
both are off by default.

Process model: without ``--leg`` this module is an orchestrator that runs
each leg in a process of its own (``--leg NAME``) and never touches the
card itself. Stdout: the flagship's JSON line (``metric``, ``value``,
``unit``, ``device``, ``card``, ``r1_steps``, ``peak_gib``) is printed and
flushed the moment its leg returns; on the card the secondary legs follow,
each cut at ``LEG_TIMEOUT_S`` (the flagship at ``FLAGSHIP_TIMEOUT_S``), and
then the same record with ``secondary`` (each leg's value, or an
``error: ...`` string). A crash after the flagship line re-emits its record
with ``secondary_error``; a flagship failure prints one line with ``value``
0.0 and ``error`` and exits non-zero. ``--device cuda`` (the default)
raises without a card; nothing falls back to the CPU. ``main(argv)`` runs
in process and returns the last record.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

from vqvae_tpu_torch.bench_breakdown import remat_arg

METRIC = ("train images/sec/chip, 256^2 gumbel VQGAN "
          "(LPIPS + StyleGAN2 D + R1/16)")
UNIT = "images/sec/chip"
SECONDARY_LEGS = ("ema_vqvae", "standard_vqvae", "entropy_vqvae", "gan_b32_plain")
PLAIN_LEGS = {"ema_vqvae": "ema", "standard_vqvae": "standard", "entropy_vqvae": "entropy"}
QUANTIZER_PARAMS = {
    "standard": {"commitment_cost": 0.25},
    "ema": {"commitment_cost": 0.25, "decay": 0.95, "epsilon": 1e-5},
    # example_confs/entropy_vqvae.yaml
    "entropy": {"ent_loss_ratio": 0.1, "ent_temperature": 0.01,
                "ent_loss_type": "softmax", "commitment_cost": 0.25},
}
SECONDARY_BATCH = 32
WARMUP = 3
STEPS = 16      # one R1 cycle per window
WINDOWS = 3
# a leg process's time limit: the flagship takes ~620 s on an H100, a
# secondary leg at most ~90 s
FLAGSHIP_TIMEOUT_S = 1200.0
LEG_TIMEOUT_S = 300.0
ROOT = Path(__file__).resolve().parent.parent


def flagship_raw(on_card: bool):
    """The flagship config dict (the published gumbel-VQGAN recipe) and its
    sizing: -> (raw, image_size, batch, grad_accum_steps)."""
    image_size = 256 if on_card else 32
    batch = int(os.environ.get("VQGAN_BENCH_BATCH", 32 if on_card else 8))
    raw = {
        "image_size": image_size,
        "autoencoder": {"channels": 128 if on_card else 32, "num_res_blocks": 2,
                        "channel_multipliers": [1, 2, 2, 4] if on_card else [1, 2]},
        "quantizer": {"num_embeddings": 1024 if on_card else 64,
                      "embedding_dim": 256 if on_card else 16,
                      "type": "gumbel", "reinit_every_n_epochs": None,
                      "params": {"straight_through": False, "temp": 1.0,
                                 "kl_cost": 0.00859375, "kl_warmup_epochs": 0.48,
                                 "temp_decay_epochs": 15, "temp_final": 0.0625}},
        "loss": {"l1_weight": 0.8, "l2_weight": 0.2, "perc_weight": 1.0,
                 "adversarial_params": {"start_epoch": 0, "loss_type": "non-saturating",
                                        "g_weight": 0.1, "use_adaptive": False,
                                        "r1_reg_weight": 10.0, "r1_reg_every": 16}},
        "training": {"cumulative_bs": 256, "base_lr": 1e-4, "betas": [0.0, 0.99],
                     "eps": 1e-8, "weight_decay": 1e-4, "decay_epochs": 250,
                     "max_epochs": 300},
    }
    # 8 micro-batches of 32: the published cumulative 256 on one card
    accum = int(os.environ.get("VQGAN_BENCH_ACCUM", 8 if on_card else 1))
    if accum > 1:
        batch *= accum
        raw["training"]["grad_accum_steps"] = accum
    return raw, image_size, batch, accum


def gan_plain_raw(base_raw: dict) -> dict:
    """The flagship's dict without accumulation (the ``gan_b32_plain`` leg)."""
    raw = copy.deepcopy(base_raw)
    raw["training"].pop("grad_accum_steps", None)
    return raw


def plain_raw(base_raw: dict, q_type: str) -> dict:
    """The flagship's dict as a non-GAN VQ-VAE with quantizer ``q_type``."""
    raw = gan_plain_raw(base_raw)
    raw.pop("loss", None)
    raw["quantizer"]["type"] = q_type
    raw["quantizer"]["params"] = copy.deepcopy(QUANTIZER_PARAMS[q_type])
    return raw


def _on_card(device) -> bool:
    import torch
    return torch.device(device).type == "cuda"


def _finish(metrics: dict, device) -> None:
    """Wait for the device's work up to ``metrics``: a synchronisation and a
    fetch of the loss, which depends on every step before it."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    float(metrics["loss"])


def time_windows(trainer, state, batch: dict, warmup: int = WARMUP, steps: int = STEPS,
                 windows: int = WINDOWS) -> dict:
    """``warmup`` steps at epoch 0, then ``windows`` windows of ``steps``
    steps on the host clock, each ended by ``_finish``. -> {"windows_s",
    "r1_at" (the host steps that took R1, warm-up included), "r1_steps"
    (how many of them the windows hold), "finite" (every metric of every
    step, read after the last window)}."""
    start = trainer.host_step
    r1, metrics = [], []

    def step():
        r1.append(trainer.r1_due(0))
        metrics.append(trainer.train_step(state, batch, epoch=0)[1])

    for _ in range(warmup):
        step()
    if metrics:
        _finish(metrics[-1], trainer.device)
    seconds = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        _finish(metrics[-1], trainer.device)
        seconds.append(time.perf_counter() - t0)
    return {"windows_s": seconds, "r1_at": [start + i for i, r in enumerate(r1) if r],
            "r1_steps": sum(r1[warmup:]),
            "finite": all(math.isfinite(float(v)) for m in metrics for v in m.values())}


def _leg(raw: dict, batch: int, device, remat, warmup: int, steps: int, windows: int) -> dict:
    """One leg: its Trainer, state and staged batch, then ``time_windows``.
    -> that dict with "value" (images/s of the median window), "batch" and
    "peak_gib" (the card's peak since the leg began; None on the CPU)."""
    import numpy as np
    import torch

    from vqvae_tpu_torch.config import parse_config
    from vqvae_tpu_torch.train.loop import Trainer, fused_backward_from_env

    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    trainer = Trainer(parse_config(raw), learning_rate=1e-4, seed=0, steps_per_epoch=1000,
                      compute_dtype=torch.bfloat16, remat=remat, device=device,
                      **fused_backward_from_env())
    state = trainer.init_state()
    size = raw["image_size"]
    images = np.random.RandomState(0).randint(0, 255, (batch, size, size, 3), np.uint8)
    # staged once: host-to-device copies are the input pipeline's (bench_input)
    out = time_windows(trainer, state, {"image": torch.from_numpy(images).to(device)},
                       warmup, steps, windows)
    out.update(value=batch * steps / statistics.median(out["windows_s"]), batch=batch,
               peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30 if on_card else None)
    return out


def bench_flagship(device="cuda", *, warmup: int = WARMUP, steps: int = STEPS,
                   windows: int = WINDOWS) -> dict:
    """The flagship leg (see ``_leg``)."""
    raw, _, batch, _ = flagship_raw(_on_card(device))
    return _leg(raw, batch, device, remat_arg(os.environ.get("VQGAN_BENCH_REMAT", "0")),
                warmup, steps, windows)


def bench_gan_plain(device="cuda", *, warmup: int = WARMUP, steps: int = STEPS,
                    windows: int = WINDOWS) -> dict:
    """The flagship's GAN step at batch 32 without accumulation, remat off."""
    raw = gan_plain_raw(flagship_raw(_on_card(device))[0])
    return _leg(raw, SECONDARY_BATCH, device, False, warmup, steps, windows)


def bench_plain(q_type: str, device="cuda", *, warmup: int = WARMUP, steps: int = STEPS,
                windows: int = WINDOWS) -> dict:
    """A non-GAN VQ-VAE step with quantizer ``q_type`` at batch 32, remat off."""
    raw = plain_raw(flagship_raw(_on_card(device))[0], q_type)
    return _leg(raw, SECONDARY_BATCH, device, False, warmup, steps, windows)


def run_leg(name: str, device: str) -> dict:
    """One leg in this process; prints and returns its JSON record."""
    import torch

    from vqvae_tpu_torch.bench_infer import card_line

    if name == "flagship":
        out = bench_flagship(device)
    elif name == "gan_b32_plain":
        out = bench_gan_plain(device)
    else:
        out = bench_plain(PLAIN_LEGS[name], device)
    if not out["finite"]:
        raise RuntimeError(f"leg {name}: a metric is not finite")
    on_card = _on_card(device)
    record = {"metric": METRIC} if name == "flagship" else {"leg": name}
    record.update(value=out["value"], unit=UNIT,
                  device=torch.cuda.get_device_name() if on_card else "cpu",
                  card=card_line() if on_card else None, r1_steps=out["r1_steps"],
                  peak_gib=out["peak_gib"])
    print(json.dumps(record), flush=True)
    return record


def _run_leg_subprocess(name: str, device: str, timeout_s: float) -> dict:
    """One leg in a process of its own: its JSON record or {"error": ...}.
    The leg's stderr is passed on."""
    cmd = [sys.executable, "-m", "vqvae_tpu_torch.bench", "--leg", name, "--device", device]
    try:
        r = subprocess.run(cmd, cwd=ROOT, timeout=timeout_s, capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        return {"error": f"error: leg {name} timed out after {timeout_s:.0f}s"}
    if r.stderr:
        sys.stderr.write(r.stderr)
    if r.returncode != 0:
        tail = r.stderr.strip().splitlines()
        return {"error": f"error: leg {name} rc={r.returncode}: "
                         f"{tail[-1] if tail else '?'}"[:300]}
    for line in reversed(r.stdout.strip().splitlines()):
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                break
    return {"error": f"error: leg {name} produced no JSON line"}


def _failed(err: str):
    """The flagship's failure: one line with value 0.0, then a non-zero exit."""
    print(json.dumps({"metric": METRIC, "value": 0.0, "unit": UNIT, "error": err}), flush=True)
    raise SystemExit(1)


def _orchestrate(device: str, sent: list) -> dict:
    result = _run_leg_subprocess("flagship", device, FLAGSHIP_TIMEOUT_S)
    if "error" in result:
        _failed(result["error"])
    sent.append(dict(result))
    print(json.dumps(result), flush=True)
    if device != "cuda":
        return result
    accum = flagship_raw(True)[3]
    secondary = {}
    for name in SECONDARY_LEGS:
        if name == "gan_b32_plain" and accum <= 1:
            continue
        leg = _run_leg_subprocess(name, device, LEG_TIMEOUT_S)
        secondary[name] = leg.get("error", leg.get("value"))
    result["secondary"] = secondary
    print(json.dumps(result), flush=True)
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run; cuda needs a visible card")
    ap.add_argument("--leg", choices=("flagship",) + SECONDARY_LEGS,
                    help="run this one leg here (the orchestrator's child)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible "
                           "(pass --device cpu to run on the CPU)")
    if args.leg:
        return run_leg(args.leg, args.device)
    sent = []   # the flagship record, once printed
    try:
        return _orchestrate(args.device, sent)
    except Exception as exc:  # noqa: BLE001 -- the last line must stay a record
        traceback.print_exc()
        err = f"bench failed: {type(exc).__name__}: {exc}"[:300]
        if not sent:
            _failed(err)
        record = dict(sent[0], secondary_error=err)
        print(json.dumps(record), flush=True)
        return record


if __name__ == "__main__":
    main()
