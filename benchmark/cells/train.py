"""Traffic kind ``train``: the port's training step,
``vqvae_tpu_torch.train.loop.Trainer.train_step``, with the Trainer built
as ``run_training`` builds it from the config (the train CLI's defaults:
the traffic's precision, remat by the gate, the fused D backward off).

The traffic file gives the micro-batch (one rank's share of the
deployment's cumulative batch), the precision, the epoch the run stands at,
the size of the pool of pinned host batches, the number of first steps the
reference follows and which of their losses are compared, and the
window's unit: ``step`` (the window is
``--seconds`` of steps) or ``r1_cycle`` (whole cycles of ``r1_reg_every``
steps, opening on an R1 step; as many as fit in ``--seconds``, at least
one).

Set-up builds the Trainer and its state, loads the benchmark's weights,
sets the state to the traffic's epoch (as a resume does), and drives the
first ``check_steps`` steps through the window's own call and feed on
distinct batches; the comparison reads their losses, the first gradient
(from the optimizer's state after one step) and every leaf's change
after the last. Set-up then steps on until the window may open.
"""

from __future__ import annotations

import time

import torch

from benchmark import compare, flops, inputs, reference
from benchmark.runtime import (Outcome, Stamp, free, host_pool, load_weights, peak_bytes,
                               sync, weight_specs)
from benchmark.trace import Trace, profiled, reduce

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# the port's span around one call of the timed path: a traced window's top level
TOP_SPAN = "train.step"
# calibrate's window for the port's readings: none, the first steps of set-up
# are what a run compares
CHECK_WINDOW_S = None
FAULTS = ("half_batch",)


def schedule(ctx):
    """(start step, start D step, r1 every or None) of the run: the state at
    the traffic's epoch, moved into it so that the first step takes R1
    where the window opens on R1 steps."""
    cfg, t = ctx.cfg, ctx.traffic
    spe = cfg["assumed"]["steps_per_epoch"]
    adv = (cfg.get("loss") or {}).get("adversarial_params")
    every = adv["r1_reg_every"] if adv and adv.get("r1_reg_weight") is not None else None
    active = adv is not None and t["epoch"] >= adv["start_epoch"]
    offset = (-t["epoch"] * spe) % every if (every and t["window"] == "r1_cycle") else 0
    step = t["epoch"] * spe + offset
    disc_step = (t["epoch"] - adv["start_epoch"]) * spe + offset if active else 0
    return step, disc_step, (every if active else None)


def _named(module, prefix):
    return {id(p): f"{prefix}.{k}" for k, p in module.named_parameters()}


def first_grads(state) -> dict:
    """Each leaf's first gradient as the optimizer got it, from its state
    after one step: AdamW's first moment is (1 - beta1) g."""
    out = {}
    pairs = [(state.optimizer, _named(state.model, "model"))]
    if state.disc_optimizer is not None:
        pairs.append((state.disc_optimizer, _named(state.disc, "disc")))
    for opt, names in pairs:
        for group in opt.param_groups:
            b1 = group["betas"][0]
            for p in group["params"]:
                if "exp_avg" in opt.state[p]:   # a model that took no step has none
                    m = opt.state[p]["exp_avg"]
                    out[names[id(p)]] = float(torch.linalg.vector_norm(m.double()) / (1 - b1))
    return out


def changes(state, weights: dict) -> dict:
    """Every leaf's norm of (now - the benchmark's initial weights)."""
    leaves = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    if state.disc is not None:
        leaves.update({f"disc.{k}": v for k, v in state.disc.state_dict().items()})
    return {k: float(torch.linalg.vector_norm((v.detach() - weights[k]).double()))
            for k, v in leaves.items()}


def reference_readings(ctx, mode: str = "fp32", half_batch: bool = False) -> dict:
    """The plain reference's readings of the same first steps; ``mode`` and
    ``half_batch`` put a lower precision or a fault in its place."""
    from benchmark.reference import numerics
    from benchmark.reference.train import Run
    t = ctx.traffic
    step, disc_step, every = schedule(ctx)
    weights = inputs.make_weights(weight_specs(ctx.cfg), ctx.cfg, ctx.seed, ctx.device)
    size = ctx.cfg["image_size"]
    with numerics.mode(mode):
        run = Run(ctx.cfg, weights, ctx.seed, step, disc_step,
                  ctx.cfg["assumed"]["steps_per_epoch"], t["epoch"],
                  lambda i: every is not None and (step + i) % every == 0, ctx.device,
                  half_batch=half_batch)
        losses = [{k: v for k, v in run.step(inputs.images(ctx.seed, i % t["pool"], t["batch"],
                                                         size, ctx.device)).items()
               if k in t["losses"]}
              for i in range(t["check_steps"])]
    readings = {"losses": losses, "grads": run.first_grads, "changes": run.changes(),
                "usage_total": run.usage_total}
    del run, weights
    free(ctx.device)
    return readings


def reference_numbers(ctx, mode: str, fault: str = None) -> dict:
    """The compared numbers with the plain reference in ``mode`` (with
    ``fault``, one of ``FAULTS``, if given) put in the port's place, against
    the reference in fp32."""
    if fault not in (None, *FAULTS):
        raise ValueError(f"no fault {fault!r} to read on a training cell; {FAULTS}")
    want = reference_readings(ctx)
    return compare.train_numbers(reference_readings(ctx, mode, half_batch=fault == "half_batch"),
                                 want)


def run(ctx) -> Outcome:
    from vqvae_tpu_torch.config import parse_config
    from vqvae_tpu_torch.ops import vq
    from vqvae_tpu_torch.train.loop import Trainer

    t, dev = ctx.traffic, ctx.device
    cfg = parse_config(ctx.model_cfg)
    batch, size = t["batch"], cfg.image_size
    trainer = Trainer(cfg=cfg, learning_rate=cfg.training.scaled_lr(), seed=ctx.seed,
                      steps_per_epoch=ctx.cfg["assumed"]["steps_per_epoch"],
                      compute_dtype=DTYPES[t["precision"]], device=dev,
                      fused_dbwd=False, fused_skip=False, per_device_batch=batch,
                      disc_kwargs=ctx.cfg.get("discriminator"))
    state = trainer.init_state()
    weights = inputs.make_weights(weight_specs(ctx.cfg), ctx.cfg, ctx.seed, dev)
    modules = {"model": state.model}
    if state.disc is not None:
        modules.update(disc=state.disc, lpips=trainer.losses.lpips)
    load_weights(modules, weights)
    step0, disc_step0, every = schedule(ctx)
    state.step, state.disc_step = step0, disc_step0
    trainer.sync_host_step(state)
    pool = host_pool(inputs.images(ctx.seed, i, batch, size, dev) for i in range(t["pool"]))
    epoch = t["epoch"]
    keys = t["losses"]

    def step(i):
        return trainer.train_step(state, {"image": pool[i % len(pool)]}, epoch)[1]

    prog = {"losses": []}
    for i in range(t["check_steps"]):
        metrics = step(i)
        prog["losses"].append({k: float(metrics[k]) for k in keys})
        if i == 0:
            prog["grads"] = first_grads(state)
    prog["changes"] = changes(state, weights)
    prog["usage_total"] = int(state.usage_count.sum())   # the epoch's histogram
    del weights
    if not ctx.measure:
        del state, trainer, pool, modules
        free(dev)
        return Outcome(metrics={}, numbers=compare.train_numbers(prog, reference_readings(ctx)),
                       attempted=0)
    i = t["check_steps"]
    while t["window"] == "r1_cycle" and not trainer.r1_due(epoch):
        step(i)
        i += 1
    sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    launches0 = vq.nearest_codes_stats.launches
    stamps, r1_steps, n_steps = [], 0, 0
    limit = t.get("trace_steps") if ctx.trace else None
    cycles = t.get("trace_cycles") if ctx.trace else None
    with profiled(ctx.trace) as prof:
        t0 = time.perf_counter()
        while True:
            r1 = trainer.r1_due(epoch)
            a = Stamp(dev) if ctx.trace else None
            step(i)
            if ctx.trace:
                stamps.append(("r1" if r1 else "plain", a, Stamp(dev)))
            i, n_steps, r1_steps = i + 1, n_steps + 1, r1_steps + r1
            if t["window"] == "r1_cycle":
                if n_steps % every:
                    continue
                sync(dev)
                elapsed = time.perf_counter() - t0
                if (elapsed + elapsed / (n_steps // every) > ctx.seconds
                        or (cycles and n_steps // every >= cycles)):
                    break
            elif time.perf_counter() - t0 >= ctx.seconds or (limit and n_steps >= limit):
                break
        sync(dev)
        window_s = time.perf_counter() - t0
    out = Outcome(metrics={"setup_s": setup_s,
                           "train_images_per_s": n_steps * batch / window_s},
                  numbers={}, attempted=n_steps)
    out.info = {"r1_steps_in_window": r1_steps, "steps_in_window": n_steps,
                "window_s": window_s,
                "b2_launches_in_window": vq.nearest_codes_stats.launches - launches0,
                "b1_launches_total": vq.nearest_codes.launches,
                "b2_launches_total": vq.nearest_codes_stats.launches}
    out.memory_peak_bytes = peak_bytes(dev)
    if ctx.trace:
        tr = Trace(kind="train", window_s=window_s, images=n_steps * batch)
        tr.step_ms = [(label, a.ms_until(b)) for label, a, b in stamps]
        tr.counters = {"b2": vq.nearest_codes_stats.launches - launches0}
        latent = reference.of(ctx.cfg).latent_side(ctx.cfg)
        tr.shapes = {"b2": (batch * latent * latent, cfg.quantizer.num_embeddings,
                            cfg.quantizer.embedding_dim)}
        out.breakdown = reduce(prof, tr) if prof is not None else None
        tr.flops_per_image = flops.train_flops_per_image(ctx.cfg, batch)
        out.trace = tr
    del state, trainer, pool, modules
    free(dev)
    out.numbers = compare.train_numbers(prog, reference_readings(ctx))
    return out
