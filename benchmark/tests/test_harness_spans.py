"""The per-layer metrics read from the port's spans (``source:
"program_span"``): a tiny traced run of each cell on the CPU prints every
one that applies to it, non-null, with ``correct`` true, and the spans
nest as the metrics assume. On the card only, the GAN cell's spans agree
with the outside timers:

    python3 -m pytest benchmark/tests/test_harness_spans.py -m cuda
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark import run
from benchmark.run import HERE
from benchmark.tests import tiny

ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = [m for m in BENCH["per_layer"] if m["source"] == "program_span"]
CELLS = [w["name"] for w in BENCH["workloads"]]
TRAIN = "gumbel_vqgan.train_gan"


def traced(cell: str, seed: int, seconds: float, root: Path, here: Path, capsys,
           allow_cpu: bool) -> dict:
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", "1"], root=root, here=here, allow_cpu=allow_cpu)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def device_ms(spans: list, name: str, top: str = None) -> list:
    """Per top-level span named ``top`` (all, if None), the summed device ms
    of its spans named ``name``."""
    tops = [s for s in spans if s["parent"] is None and (top is None or s["name"] == top)]
    return [sum(s["device_ms"] for s in spans if s["id"] == t["id"] and s["name"] == name)
            for t in tops]


def test_every_cell_with_a_span_metric_names_its_readers():
    assert SPAN_METRICS
    for m in SPAN_METRICS:
        assert m["unit"] == "ms" and m["better"] == "lower" and len(m["workloads"]) == 1
        assert (HERE / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_prints_the_span_metrics(tmp_path, capsys, cell):
    from vqvae_tpu_torch.utils.introspect import span_log
    root, here = tiny.make(tmp_path, fp32=True)
    out = traced(cell, 2 ** 31 + 9, 0.5, root, here, capsys, allow_cpu=True)
    assert out["correct"] is True, out["checks"]
    want = [m["name"] for m in SPAN_METRICS if cell in m["workloads"]]
    assert want
    for name in want:
        assert out["metrics"][name]["value"] is not None, name
        assert out["metrics"][name]["value"] > 0, name
    spans = span_log()
    tops = {s["name"] for s in spans if s["parent"] is None}
    if cell == TRAIN:
        assert tops == {"train.step"}
    elif cell == "ema_vqvae.tokenize":
        assert tops == {"api.get_tokens"}
        api = device_ms(spans, "api.get_tokens")
        assert all(e <= a for e, a in zip(device_ms(spans, "encoder"), api))
    else:
        assert tops == {"api.reconstruct_from_tokens"}
        metrics = {k: v["value"] for k, v in out["metrics"].items()}
        api = device_ms(spans, "api.reconstruct_from_tokens")
        assert metrics["norm_act_ms"] <= metrics["decoder_ms"] <= sum(api) / len(api)


@pytest.mark.cuda
def test_train_step_span_agrees_with_the_outside_timers(capsys):
    """The mean device ms of ``train.step`` is within 2% of ``r1_step_ms``
    and of ``gan_step_ms`` (CUDA events the benchmark records around
    ``Trainer.train_step``), and the step's phases cover 95% of it."""
    if not torch.cuda.is_available():
        pytest.skip("the GAN cell runs at its size on a CUDA card")
    from vqvae_tpu_torch.utils.introspect import span_log
    out = traced(TRAIN, 2 ** 31 + 13, 51, ROOT, HERE, capsys, allow_cpu=False)
    assert out["correct"] is True, out["checks"]
    spans = span_log()
    steps = [s for s in spans if s["name"] == "train.step"]
    for label, r1 in (("r1_step_ms", True), ("gan_step_ms", False)):
        mine = [s["device_ms"] for s in steps if s["attrs"]["r1"] == r1]
        outside = out["metrics"][label]["value"]
        assert abs(sum(mine) / len(mine) - outside) <= 0.02 * outside, (label, mine, outside)
    for step in steps:
        phases = sum(s["device_ms"] for s in spans if s["parent"] == step["index"])
        assert phases >= 0.95 * step["device_ms"], (step, phases)
