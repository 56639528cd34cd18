"""The control of every cell comes out not correct: the plain reference, put
in the port's place and computed in the next precision below the
configuration's (fp8 for bf16, TF32 for fp32), judged by the cell's own
limits, at the cell's own size on three seeds. On the card only:

    python3 -m pytest benchmark/tests/test_harness_control.py -m cuda

(The training cells' faults are read by ``benchmark.calibrate`` on the
card and run through the harness here by ``test_harness_faults.py``.)"""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

from benchmark import calibrate, compare
from benchmark.run import HERE, load_cell
from benchmark.runtime import Context

ROOT = HERE.parent
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 103, 2 ** 31 + 107)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's size, on a CUDA card")
    _, entry, config, traffic, limits = load_cell(ROOT, HERE, cell)
    for seed in SEEDS:
        ctx = Context(cell=cell, cfg=config, traffic=traffic, seed=seed, seconds=0,
                      trace=False, device=torch.device("cuda", 0), t_start=time.perf_counter())
        numbers = calibrate.readings(ctx, ["control"])["control"]
        correct, checks = compare.judge(numbers, limits)
        assert not correct, (seed, checks)


def test_the_control_is_one_precision_down():
    assert calibrate.LOWER == {"bf16": "fp8", "fp32": "tf32"}
    for cell in CELLS:
        traffic = load_cell(ROOT, HERE, cell)[3]
        assert traffic["precision"] in calibrate.LOWER
    assert Path(calibrate.__file__).parent == HERE
