"""Traffic kind ``tokenize``: token export as ``cli/tokenize_dataset.py`` runs
it, one caller in a closed loop.

The model is built as the CLI builds it (a ``Trainer`` without the loss
block, in the traffic's precision; fp32 with TF32 off, the CLI's
``set_full_fp32``), with the benchmark's weights. A request takes a pinned
host uint8 batch of the pool to the card, calls ``get_tokens`` (with the
gumbel quantizer ``deterministic``, the CLI's default) and brings the
codes back to the host. The window is ``--seconds`` of requests; every
request's codes are kept, and a sample drawn from the seed is compared
with the plain reference's nearest codes on every row.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from benchmark import compare, flops, inputs, reference
from benchmark.runtime import (Outcome, free, host_pool, load_weights, peak_bytes, sample,
                               sync, weight_specs)
from benchmark.trace import Trace, profiled, reduce

# the port's span around one call of the timed path: a traced window's top level
TOP_SPAN = "api.get_tokens"
# calibrate's window for the port's readings: long enough to serve as many
# requests as a run compares
CHECK_WINDOW_S = 4.0


def build(ctx):
    from vqvae_tpu_torch.config import parse_config
    from vqvae_tpu_torch.train.loop import Trainer
    from vqvae_tpu_torch.utils.precision import set_full_fp32

    if ctx.traffic["precision"] != "fp32":
        raise ValueError("token export runs in fp32, as the CLI does")
    set_full_fp32()
    cfg = parse_config(ctx.model_cfg)
    trainer = Trainer(cfg=dataclasses.replace(cfg, loss=None),
                      learning_rate=cfg.training.base_lr, seed=ctx.seed, steps_per_epoch=1,
                      compute_dtype=torch.float32, device=ctx.device)
    model = trainer.init_state().model
    weights = inputs.make_weights(weight_specs(ctx.cfg), ctx.cfg, ctx.seed, ctx.device)
    load_weights({"model": model}, {k: v for k, v in weights.items() if k.startswith("model.")})
    return model.eval(), cfg


def reference_codes(ctx, requests: list, mode: str = "fp32") -> list:
    """The reference's latents of each request's images, in ``mode``."""
    from benchmark.reference import numerics
    from benchmark.reference.train import encode_latents
    t = ctx.traffic
    weights = inputs.make_weights(weight_specs(ctx.cfg), ctx.cfg, ctx.seed, ctx.device)
    out = []
    with numerics.mode(mode):
        for r in requests:
            x = inputs.images(ctx.seed, r % t["pool"], t["batch"], ctx.cfg["image_size"],
                              ctx.device)
            out.append(encode_latents(ctx.cfg, weights, x))
    return out, weights["model.quantizer.codebook.weight"]


def numbers_for(latents: list, codebook, codes: list) -> dict:
    parts = [compare.code_gap(z, codebook, c.to(z.device).reshape(-1))
             for z, c in zip(latents, codes)]
    return {"code_gap": max(p["code_gap"] for p in parts),
            "codes_differing": sum(p["codes_differing"] for p in parts) / len(parts)}


def reference_numbers(ctx, mode: str, fault: str = None) -> dict:
    """The compared numbers with the plain reference in ``mode`` put in the
    port's place (its latents and nearest codes in ``mode``), against the
    reference in fp32, over as many requests as a run compares."""
    from benchmark.reference import nets, numerics
    if fault is not None:
        raise ValueError(f"no fault {fault!r} to read on the reference of token export")
    requests = list(range(ctx.traffic["check_requests"]))
    latents, codebook = reference_codes(ctx, requests)
    low, _ = reference_codes(ctx, requests, mode=mode)
    with numerics.mode(mode):
        codes = [nets.scores(z, codebook).argmin(1) for z in low]
    return numbers_for(latents, codebook, codes)


def run(ctx) -> Outcome:
    from vqvae_tpu_torch.ops import vq

    t, dev = ctx.traffic, ctx.device
    model, cfg = build(ctx)
    gumbel = cfg.quantizer.type == "gumbel"
    pool = host_pool(inputs.images(ctx.seed, i, t["batch"], cfg.image_size, dev)
                     for i in range(t["pool"]))

    def request(i):
        images = pool[i % len(pool)].to(dev, non_blocking=True).float() / 255.0
        tokens = (model.get_tokens(images, deterministic=True) if gumbel
                  else model.get_tokens(images))
        return tokens.cpu()

    for i in range(t["warmup"]):
        request(i)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    launches0 = vq.nearest_codes.launches
    served, limit = [], t.get("trace_requests") if ctx.trace else None
    with profiled(ctx.trace) as prof:
        t0 = time.perf_counter()
        while True:
            served.append(request(len(served)))
            if time.perf_counter() - t0 >= ctx.seconds or (limit and len(served) >= limit):
                break
        window_s = time.perf_counter() - t0
    n = len(served)
    out = Outcome(metrics={"setup_s": setup_s,
                           "tokenize_images_per_s": n * t["batch"] / window_s},
                  numbers={}, attempted=n)
    out.info = {"requests_in_window": n, "window_s": window_s,
                "b1_launches_in_window": vq.nearest_codes.launches - launches0,
                "b1_launches_total": vq.nearest_codes.launches,
                "b2_launches_total": vq.nearest_codes_stats.launches}
    out.memory_peak_bytes = peak_bytes(dev)
    if ctx.trace:
        tr = Trace(kind="tokenize", window_s=window_s, images=n * t["batch"])
        tr.counters = {"b1": vq.nearest_codes.launches - launches0}
        latent = reference.of(ctx.cfg).latent_side(ctx.cfg)
        tr.shapes = {"b1": (t["batch"] * latent * latent, cfg.quantizer.num_embeddings,
                            cfg.quantizer.embedding_dim)}
        out.breakdown = reduce(prof, tr) if prof is not None else None
        tr.flops_per_image = flops.tokenize_flops_per_image(ctx.cfg)
        out.trace = tr
    picked = sample(ctx.seed, n, t["check_requests"])
    codes = [served[i] for i in picked]
    del model, pool, served
    free(dev)
    latents, codebook = reference_codes(ctx, picked)
    out.numbers = numbers_for(latents, codebook, codes)
    out.info["checked_requests"] = picked
    return out
