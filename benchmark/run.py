"""The benchmark of ``vqvae_tpu_torch`` on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. Everything is found by name from
``BENCHMARK.json``: the cell's configuration in ``configs/<config>.json``
(whose ``reference`` names the plain reference of its architecture in
``reference/<reference>.py``, ``nets`` where it names none; the interface
is in ``reference/__init__.py``), its traffic in ``traffic/<traffic>.json``
(whose ``kind`` names the driver in ``cells/<kind>.py``), its limits in
``workloads/<cell>.json``, and each per-layer metric's reader in
``metrics/<metric>.py``. A new cell, traffic mix, configuration,
architecture's reference or metric is a new file and new entries.

A run makes its weights and inputs from ``--seed``, warms up (counted in
``setup_s``), measures for ``--seconds``, then checks what the timed path
produced against the plain reference (``reference/``) and prints, on
standard output, an earlier line ``{"info": ...}`` and as its last line the
result, whose last key ``checks`` holds each compared number beside its
limit; the same numbers end standard error. With ``--trace 0`` the
result's metrics are the cell's end-to-end ones, with ``--trace 1`` its
per-layer ones, read from a ``torch.profiler`` trace of the window.

It exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), and when ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``vqvae_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vqvae_tpu")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_cell(root: Path, here: Path, name: str):
    """-> (benchmark, cell entry, config, traffic, limits) for workload ``name``."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    config = _json(here / "configs" / f"{cell['config']}.json")
    traffic = _json(here / "traffic" / f"{cell['traffic']}.json")
    limits_file = here / "workloads" / f"{name}.json"
    limits = _json(limits_file)["limits"] if limits_file.exists() else {}
    return bench, cell, config, traffic, limits


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def read_metric(here: Path, name: str, trace):
    """Load ``metrics/<name>.py`` by path and call its ``read(trace)``."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  here / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(trace)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_info(torch) -> dict:
    import subprocess
    info = {"name": torch.cuda.get_device_name(0)}
    try:
        info["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        info["nvidia_smi"] = f"unavailable: {e}"
    return info


def main(argv=None, root=None, here=None, allow_cpu: bool = False) -> int:
    """Run one cell. ``root`` holds ``BENCHMARK.json`` (the working
    directory), ``here`` the files found by name (this package's). Tests
    only: ``allow_cpu`` skips the look for a card and runs on the CPU."""
    t_start = time.perf_counter()
    args = parse_args(argv)
    root = Path(root) if root is not None else Path.cwd()
    here = Path(here) if here is not None else HERE
    bench, cell, config, traffic, limits = load_cell(root, here, args.workload)
    # build caches at fixed paths inside the checkout (the port's own nvcc
    # builds go to vqvae_tpu_torch/_build/, also inside it)
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    import torch

    if allow_cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"needs {cell['chips']} CUDA card(s); "
                  f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    from benchmark.runtime import Context
    ctx = Context(cell=cell["name"], cfg=config, traffic=traffic, seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace), device=device, t_start=t_start)
    driver = importlib.import_module(f"benchmark.cells.{traffic['kind']}")
    out = driver.run(ctx)

    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the port must run without JAX",
              file=sys.stderr)
        return 3
    from benchmark.compare import judge
    correct, checks = judge(out.numbers, limits)
    if not limits:
        correct = False
        print(f"no limits for {cell['name']} (workloads/{cell['name']}.json)", file=sys.stderr)

    metrics = {}
    if args.trace:
        for m in bench["per_layer"]:
            if _applies(m, cell["name"]):
                value = read_metric(here, m["name"], out.trace)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if _applies(m, cell["name"]) and m["name"] in out.metrics:
                metrics[m["name"]] = {"value": out.metrics[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": out.memory_peak_bytes}
    if args.trace and out.trace is not None:
        dev.update(busy_s=out.trace.busy_s, window_s=out.trace.window_s)
    info = dict(out.info, cell=cell["name"], seed=args.seed,
                memory_peak_bytes=out.memory_peak_bytes, numbers=out.numbers,
                end_to_end=out.metrics)
    if device.type == "cuda":
        info["card"] = card_info(torch)
    print(json.dumps({"info": info}), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if args.trace and out.breakdown:
        result["breakdown"] = out.breakdown
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
