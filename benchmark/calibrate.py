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

from benchmark.run import HERE, load_cell
from benchmark.runtime import Context

LOWER = {"bf16": "fp8", "fp32": "tf32"}


def readings(ctx, whats) -> dict:
    """{what: numbers} on one seed, each read by the cell's driver
    (``cells/<kind>.py``). ``program``: the port's own readings, as a run
    takes them, in the driver's ``CHECK_WINDOW_S`` (None: no window, the
    first steps of set-up); ``control``: the reference one precision down
    in the port's place; any other: that fault of the driver's on the
    reference."""
    t = ctx.traffic
    driver = importlib.import_module(f"benchmark.cells.{t['kind']}")
    out = {}
    for what in whats:
        if what == "program":
            ctx.measure = driver.CHECK_WINDOW_S is not None
            ctx.seconds = driver.CHECK_WINDOW_S or 0.0
            out[what] = driver.run(ctx).numbers
        elif what == "control":
            out[what] = driver.reference_numbers(ctx, LOWER[t["precision"]])
        else:
            out[what] = driver.reference_numbers(ctx, "fp32", fault=what)
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
