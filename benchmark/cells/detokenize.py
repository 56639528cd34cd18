"""Traffic kind ``detokenize``: a stage-2 sampler decoding its tokens with
``VQVAE.reconstruct_from_tokens``, one caller in a closed loop.

The model is built with ``VQVAE.from_config`` in the traffic's precision,
with the benchmark's weights. A request takes a pinned host batch of
tokens of the pool to the card, decodes it, turns the [0, 1] images into
uint8 on the card and copies them into the caller's pinned host buffer.
Each request's latency runs from a CUDA event recorded before its tokens
are copied to one recorded after its images reached the host. The window is ``--seconds``
of requests; the images of a sample of requests, drawn from the seed as
they are served, are kept and compared with the plain reference's.
"""

from __future__ import annotations

import heapq
import math
import time

import torch

from benchmark import compare, flops, inputs, reference
from benchmark.runtime import Outcome, Stamp, free, host_pool, load_weights, peak_bytes, sync, \
    weight_specs
from benchmark.trace import Trace, profiled, reduce

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# the port's span around one call of the timed path: a traced window's top level
TOP_SPAN = "api.reconstruct_from_tokens"
# calibrate's window for the port's readings: long enough to serve as many
# requests as a run compares
CHECK_WINDOW_S = 1.0


def reference_images(ctx, requests: list, mode: str = "fp32") -> list:
    from benchmark.reference import numerics
    from benchmark.reference.train import decode_tokens
    t = ctx.traffic
    weights = inputs.make_weights(weight_specs(ctx.cfg), ctx.cfg, ctx.seed, ctx.device)
    with numerics.mode(mode):
        return [decode_tokens(ctx.cfg, weights, _tokens(ctx, r % t["pool"])) for r in requests]


def _tokens(ctx, index: int):
    q, t = ctx.cfg["quantizer"], ctx.traffic
    side = reference.of(ctx.cfg).latent_side(ctx.cfg)
    return inputs.tokens(ctx.seed, index, t["batch"], side * side, q["num_embeddings"],
                         ctx.device)


def numbers_for(images: list, refs: list) -> dict:
    parts = [compare.pixel_gap(p.to(r.device), r) for p, r in zip(images, refs)]
    return {"pixel_gap": max(p["pixel_gap"] for p in parts),
            "pixel_gap_mean": sum(p["pixel_gap_mean"] for p in parts) / len(parts)}


def reference_numbers(ctx, mode: str, fault: str = None) -> dict:
    """The compared numbers with the plain reference in ``mode`` put in the
    port's place (its images rounded to uint8 as the port's are), against
    the reference in fp32, over as many requests as a run compares."""
    if fault is not None:
        raise ValueError(f"no fault {fault!r} to read on the reference of decoding")
    requests = list(range(ctx.traffic["check_requests"]))
    refs = reference_images(ctx, requests)
    low = [(x * 255.0).round().to(torch.uint8) for x in reference_images(ctx, requests, mode)]
    return numbers_for(low, refs)


def p95(values) -> float:
    """The nearest-rank 95th percentile."""
    ordered = sorted(values)
    return ordered[max(math.ceil(0.95 * len(ordered)) - 1, 0)]


def run(ctx) -> Outcome:
    from vqvae_tpu_torch.config import parse_config
    from vqvae_tpu_torch.models.vqvae import VQVAE

    t, dev = ctx.traffic, ctx.device
    cfg = parse_config(ctx.model_cfg)
    model = VQVAE.from_config(cfg, dtype=DTYPES[t["precision"]], device=dev)
    weights = inputs.make_weights(weight_specs(ctx.cfg), ctx.cfg, ctx.seed, dev)
    load_weights({"model": model}, {k: v for k, v in weights.items() if k.startswith("model.")})
    del weights
    pool = host_pool(_tokens(ctx, i) for i in range(t["pool"]))
    side = cfg.image_size
    host = host_pool([torch.empty(t["batch"], side, side, 3, dtype=torch.uint8)])[0]

    def request(i):
        """-> the images in the caller's pinned buffer, once they are there."""
        tokens = pool[i % len(pool)].to(dev, non_blocking=True)
        images = model.reconstruct_from_tokens(tokens)
        host.copy_((images * 255.0).round().to(torch.uint8), non_blocking=True)
        sync(dev)
        return host

    for i in range(t["warmup"]):
        request(i)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    # a sample of the served requests, drawn from the seed as they come: the
    # requests with the smallest seeded keys
    kept, stamps, n = [], [], 0
    limit = t.get("trace_requests") if ctx.trace else None
    with profiled(ctx.trace) as prof:
        t0 = time.perf_counter()
        while True:
            a = Stamp(dev)
            images = request(n)
            stamps.append((a, Stamp(dev)))
            key = -inputs.derive(ctx.seed, "sample", n)
            if len(kept) < t["check_requests"] or key > kept[0][0]:
                item = (key, n, images.clone())
                (heapq.heappush if len(kept) < t["check_requests"] else heapq.heappushpop)(
                    kept, item)
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds or (limit and n >= limit):
                break
        window_s = time.perf_counter() - t0
    sync(dev)
    latencies = [a.ms_until(b) for a, b in stamps]
    out = Outcome(metrics={"setup_s": setup_s,
                           "detokenize_images_per_s": n * t["batch"] / window_s,
                           "detokenize_p95_ms": p95(latencies)},
                  numbers={}, attempted=n)
    out.info = {"requests_in_window": n, "window_s": window_s,
                "latency_median_ms": sorted(latencies)[len(latencies) // 2]}
    out.memory_peak_bytes = peak_bytes(dev)
    if ctx.trace:
        tr = Trace(kind="detokenize", window_s=window_s, images=n * t["batch"])
        out.breakdown = reduce(prof, tr) if prof is not None else None
        tr.flops_per_image = flops.detokenize_flops_per_image(ctx.cfg)
        out.trace = tr
    kept.sort(key=lambda item: item[1])
    picked = [item[1] for item in kept]
    images = [item[2] for item in kept]
    del model, pool, kept, host
    free(dev)
    out.numbers = numbers_for(images, reference_images(ctx, picked))
    out.info["checked_requests"] = picked
    return out
