"""The readings that a cell's limits are set from, at the cell's own size, on
several seeds in one process. The benchmark's runs never call this.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 [--what control,half_batch]

``control``: the plain reference in the next precision below the
configuration's (``fp8`` for bf16, ``tf32`` for fp32, ``numerics.py``), put
in the port's place and compared with the reference as a run compares the
port. ``half_batch`` (training cells): the reference with half of each
batch left out, the mean taken over the rest. ``program``: the port's own
readings, as a run compares them. A step that returns its
state unchanged reads 1 on the change by construction and is not run.
Each seed prints a JSON line per reading: {"seed", "what", numbers...}.
"""

from __future__ import annotations

import argparse
import importlib
import json
import time
from pathlib import Path

import torch

from benchmark import compare
from benchmark.run import HERE, load_cell
from benchmark.runtime import Context

LOWER = {"bf16": "fp8", "fp32": "tf32"}
# a window long enough to serve as many requests as a run compares
SERVING_SECONDS = {"tokenize": 4.0, "detokenize": 1.0}


def readings(ctx, whats) -> dict:
    """{what: numbers} on one seed; the fp32 reference is computed once.
    ``program``: the port's own readings, as a run takes them (training:
    the first steps, with no window; serving: a short window)."""
    kind, t = ctx.traffic["kind"], ctx.traffic
    lower = LOWER[t["precision"]]
    out = {}
    if "program" in whats:
        whats = [w for w in whats if w != "program"]
        driver = importlib.import_module(f"benchmark.cells.{kind}")
        ctx.measure = kind != "train"
        ctx.seconds = SERVING_SECONDS.get(kind, 0.0)
        out["program"] = driver.run(ctx).numbers
        if not whats:
            return out
    if kind == "train":
        from benchmark.cells.train import reference_readings
        want = reference_readings(ctx)
        for what in whats:
            got = reference_readings(ctx, mode=lower if what == "control" else "fp32",
                                     half_batch=what == "half_batch")
            out[what] = compare.train_numbers(got, want)
        return out
    if list(whats) != ["control"]:
        raise ValueError("only training cells have faults to read here")
    requests = list(range(t["check_requests"]))
    if kind == "tokenize":
        from benchmark.cells.tokenize import numbers_for, reference_codes
        from benchmark.reference import nets, numerics
        latents, codebook = reference_codes(ctx, requests)
        low, _ = reference_codes(ctx, requests, mode=lower)
        with numerics.mode(lower):
            codes = [nets.scores(z, codebook).argmin(1) for z in low]
        out["control"] = numbers_for(latents, codebook, codes)
        return out
    from benchmark.cells.detokenize import numbers_for, reference_images
    refs = reference_images(ctx, requests)
    low = [(x * 255.0).round().to(torch.uint8) for x in reference_images(ctx, requests, lower)]
    out["control"] = numbers_for(low, refs)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--what", default="control")
    args = ap.parse_args(argv)
    _, cell, config, traffic, _ = load_cell(Path.cwd(), HERE, args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Context(cell=cell["name"], cfg=config, traffic=traffic, seed=seed, seconds=0,
                      trace=False, device=device, t_start=time.perf_counter())
        t0 = time.perf_counter()
        for what, numbers in readings(ctx, args.what.split(",")).items():
            print(json.dumps({"cell": cell["name"], "seed": seed, "what": what,
                              "seconds": time.perf_counter() - t0, **numbers}), flush=True)


if __name__ == "__main__":
    main()
