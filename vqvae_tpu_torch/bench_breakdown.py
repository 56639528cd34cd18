"""Where a VQGAN train step's time goes, term by term (counterpart of
``tools/bench_breakdown.py``).

    python -m vqvae_tpu_torch.bench_breakdown [--batch 32] [--configs mse,lpips,gan,gan_r1]
        [--fused_dbwd] [--fused_skip] [--remat 0|1|auto] [--device cuda|cpu]

Four variants of the 256^2 gumbel VQGAN (``make_cfg``, the JAX tool's raw
dict: channels 128, multipliers [1, 2, 2, 4], 2 residual blocks, N 1024,
D 256):

- ``mse``: the autoencoder alone (no ``loss:`` block);
- ``lpips``: + L1 / L2 and LPIPS-VGG;
- ``gan``: + the StyleGAN2 discriminator from epoch 0, non-saturating;
- ``gan_r1``: + R1 (weight 10) every 16 steps.

Each variant's ``Trainer`` runs at ``--batch`` in bf16 compute with seeded
random weights (LPIPS: the converted ``.npz`` if present) on one uint8
batch staged on the device once. ``time_steps`` makes 2 warm-up steps, then
16 steps: on the card between CUDA events recorded before each step and
after the last, with one synchronisation at the end (the host clock with
``--device cpu``). So host steps 2-17 are timed, and the ``gan_r1`` window
holds exactly one R1 step (host step 16), as the JAX tool's does; that
step's ms and the other steps' mean are reported apart. ``--fused_dbwd`` /
``--fused_skip`` send the discriminator's first-order backward through the
kernels B3 / B4 (the JAX Trainer's ``VQVAE_TPU_FUSED_DBWD`` /
``VQVAE_TPU_FUSED_SKIP``); both are off by default, as there. ``--remat``
is the Trainer's ``remat``: ``1`` checkpoints every residual and D block,
``auto`` lets the Trainer decide (batch unknown: on at 256^2); the default
``0`` is the JAX tool's (remat off, ``bench.py``'s flagship configuration).

Per variant it prints ``ms/step`` and ``img/s`` (the JAX tool's keys), and
for ``gan_r1`` ``r1_ms`` and ``non_r1_ms``; the last line is the JSON
record, with the device's name and, on the card, ``nvidia-smi``'s name and
power limit. Each variant's Trainer and state are freed before the next.
``main(argv)`` runs in process and returns the record; each variant's entry
also holds ``step_ms``, ``r1`` (which timed steps took R1) and ``finite``
(every metric of every timed step).
"""

from __future__ import annotations

import argparse
import json
import math
import time

VARIANTS = {
    "mse": dict(with_loss=False, with_adv=False, r1=False),
    "lpips": dict(with_loss=True, with_adv=False, r1=False),
    "gan": dict(with_loss=True, with_adv=True, r1=False),
    "gan_r1": dict(with_loss=True, with_adv=True, r1=True),
}
WARMUP = 2
STEPS = 16


def make_cfg(image_size, channels, with_loss, with_adv, r1):
    from vqvae_tpu_torch.config import parse_config
    raw = {
        "image_size": image_size,
        "autoencoder": {"channels": channels, "num_res_blocks": 2,
                        "channel_multipliers": [1, 2, 2, 4]},
        "quantizer": {"num_embeddings": 1024, "embedding_dim": 256,
                      "type": "gumbel", "reinit_every_n_epochs": None,
                      "params": {"straight_through": False, "temp": 1.0,
                                 "kl_cost": 0.00859375,
                                 "kl_warmup_epochs": 0.48,
                                 "temp_decay_epochs": 15,
                                 "temp_final": 0.0625}},
        "training": {"cumulative_bs": 256, "base_lr": 1e-4,
                     "betas": [0.0, 0.99], "eps": 1e-8, "weight_decay": 1e-4,
                     "decay_epochs": 250, "max_epochs": 300},
    }
    if with_loss:
        raw["loss"] = {"l1_weight": 0.8, "l2_weight": 0.2, "perc_weight": 1.0}
        if with_adv:
            raw["loss"]["adversarial_params"] = {
                "start_epoch": 0, "loss_type": "non-saturating",
                "g_weight": 0.1, "use_adaptive": False,
                "r1_reg_weight": 10.0 if r1 else None,
                "r1_reg_every": 16}
    return parse_config(raw)


class _HostEvent:
    """The host clock behind the interface of a CUDA event (``--device cpu``)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def _event(device):
    import torch
    return torch.cuda.Event(enable_timing=True) if device.type == "cuda" else _HostEvent()


def time_steps(trainer, state, batch_dict, n: int = STEPS) -> dict:
    """``WARMUP`` steps at epoch 0, then ``n`` steps with an event recorded
    before each and after the last, and one synchronisation after them. ->
    {"step_ms": each timed step's ms, "r1": whether it took R1, "metrics":
    its metrics as floats}."""
    import torch
    device = trainer.device
    for _ in range(WARMUP):
        trainer.train_step(state, batch_dict, epoch=0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    events, r1, metrics = [_event(device)], [], []
    events[0].record()
    for _ in range(n):
        r1.append(trainer.r1_due(0))
        _, m = trainer.train_step(state, batch_dict, epoch=0)
        metrics.append(m)
        events.append(_event(device))
        events[-1].record()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"step_ms": [a.elapsed_time(b) for a, b in zip(events, events[1:])], "r1": r1,
            "metrics": [{k: float(v) for k, v in m.items()} for m in metrics]}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--configs", default="mse,lpips,gan,gan_r1")
    ap.add_argument("--fused_dbwd", action="store_true",
                    help="the D's first-order backward through B3 (VQVAE_TPU_FUSED_DBWD)")
    ap.add_argument("--fused_skip", action="store_true",
                    help="the D's skip fan-out backward through B4 (VQVAE_TPU_FUSED_SKIP)")
    ap.add_argument("--remat", default="0", choices=["0", "1", "auto"],
                    help="the Trainer's remat: off, on, or its own decision")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run; cuda needs a visible card")
    return ap.parse_args(argv)


def remat_arg(value: str):
    """``--remat`` as the Trainer's ``remat``: 0 -> False, 1 -> True, auto -> None."""
    return None if value == "auto" else value == "1"



def main(argv=None) -> dict:
    args = parse_args(argv)

    import numpy as np
    import torch

    from vqvae_tpu_torch.bench_infer import card_line
    from vqvae_tpu_torch.train.loop import Trainer

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible "
                           "(pass --device cpu to run on the CPU)")
    device = torch.device(args.device)
    card = card_line() if on_card else None
    image_size, channels = 256, 128
    batch = args.batch
    # staged on the device once: host-to-device copies are not timed
    images = np.random.RandomState(0).randint(
        0, 255, (batch, image_size, image_size, 3), np.uint8)
    batch_dict = {"image": torch.from_numpy(images).to(device)}

    results = {}
    for name in args.configs.split(","):
        cfg = make_cfg(image_size, channels, **VARIANTS[name])
        trainer = Trainer(cfg=cfg, learning_rate=1e-4, seed=0, steps_per_epoch=1000,
                          compute_dtype=torch.bfloat16, device=device,
                          fused_dbwd=args.fused_dbwd, fused_skip=args.fused_skip,
                          remat=remat_arg(args.remat))
        state = trainer.init_state()
        t = time_steps(trainer, state, batch_dict)
        ms = sum(t["step_ms"]) / len(t["step_ms"])
        res = {"ms/step": ms, "img/s": batch * 1000 / ms}
        r1_ms = [s for s, r in zip(t["step_ms"], t["r1"]) if r]
        if r1_ms:
            plain = [s for s, r in zip(t["step_ms"], t["r1"]) if not r]
            res.update(r1_ms=sum(r1_ms) / len(r1_ms), non_r1_ms=sum(plain) / len(plain))
        res.update(step_ms=t["step_ms"], r1=t["r1"],
                   finite=all(math.isfinite(v) for m in t["metrics"] for v in m.values()))
        results[name] = res
        print(f"{name} [{card or 'cpu'}]: ms/step {ms:.1f}, img/s {res['img/s']:.1f}"
              + (f"; R1 step {res['r1_ms']:.1f} ms (window step "
                 f"{t['r1'].index(True) + 1} of {len(t['r1'])}), non-R1 mean "
                 f"{res['non_r1_ms']:.1f} ms" if r1_ms else "")
              + ("" if res["finite"] else "; NON-FINITE METRICS"), flush=True)
        del trainer, state
        if on_card:
            torch.cuda.empty_cache()

    record = {"batch": batch, "remat": args.remat, "fused_dbwd": args.fused_dbwd,
              "fused_skip": args.fused_skip,
              "device": torch.cuda.get_device_name(device) if on_card else "cpu",
              "card": card, **results}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
