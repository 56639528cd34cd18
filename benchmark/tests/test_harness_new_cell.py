"""A cell added as new files and entries only, with no edit to a file the
benchmark has: in a tiny copy (``tiny.make``), a copy of the decoding
traffic under a new name, the cell's limits, a span metric that lists only
the new cell, and the end-to-end metrics' lists of cells extended; once on
a configuration the benchmark has, once on a new configuration file that
names its plain reference by ``"reference"``. The per-cell checks that the
benchmark's own cells pass (discovery, a sound run, the span metrics of a
traced run) pass on it.

A training cell needs a reference that trains: one whose module gives no
``decay_names`` is refused with a clear error."""

from __future__ import annotations

import json
import shutil
import sys
import types
from pathlib import Path

import pytest

from benchmark import flops
from benchmark.reference import nets
from benchmark.tests import tiny
from benchmark.tests.test_harness_discovery import (check_cell_finds_its_files, check_names,
                                                     check_per_layer_metric)
from benchmark.tests.test_harness_faults import check_sound_run
from benchmark.tests.test_harness_spans import check_span_readers, check_traced_run

FROM_CELL, FROM_CONFIG, FROM_METRIC = "gumbel_vqgan.detokenize", "gumbel_vqgan", "decoder_ms"
TRAFFIC, METRIC = "detokenize_added", "decoder_ms_added"


def add_cell(root: Path, here: Path, config: str) -> str:
    """Add the cell ``<config>.detokenize_added`` to the tiny copy as files
    and entries; a ``config`` the copy lacks is added too, as a copy of
    ``gumbel_vqgan``'s file that names its reference. -> the cell's name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = f"{config}.{TRAFFIC}"
    if config not in {c["name"] for c in bench["configs"]}:
        cfg = json.loads((here / "configs" / f"{FROM_CONFIG}.json").read_text())
        (here / "configs" / f"{config}.json").write_text(
            json.dumps(dict(cfg, name=config, reference="nets")))
        entry = next(c for c in bench["configs"] if c["name"] == FROM_CONFIG)
        bench["configs"].append(dict(entry, name=config,
                                     file=f"benchmark/configs/{config}.json"))
    traffic = json.loads((here / "traffic" / "detokenize.json").read_text())
    (here / "traffic" / f"{TRAFFIC}.json").write_text(json.dumps(traffic))
    shutil.copy(here / "workloads" / f"{FROM_CELL}.json", here / "workloads" / f"{cell}.json")
    shutil.copy(here / "metrics" / f"{FROM_METRIC}.py", here / "metrics" / f"{METRIC}.py")
    bench["workloads"].append({"name": cell, "config": config, "traffic": TRAFFIC, "chips": 1,
                               "why": "a copy of the decoding cell, added as files only"})
    for m in bench["end_to_end"]:
        if FROM_CELL in m.get("workloads", ()):
            m["workloads"].append(cell)
    template = next(m for m in bench["per_layer"] if m["name"] == FROM_METRIC)
    bench["per_layer"].append(dict(template, name=METRIC, workloads=[cell]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


@pytest.mark.parametrize("config", [FROM_CONFIG, "gumbel_vqgan_added"])
def test_a_cell_added_as_files_passes_the_per_cell_checks(tmp_path, capsys, config):
    root, here = tiny.make(tmp_path, fp32=True)
    cell = add_cell(root, here, config)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    check_names(bench)
    check_cell_finds_its_files(root, here, cell)
    check_per_layer_metric(here, bench, bench["per_layer"][-1])
    check_span_readers(root, here)
    check_sound_run(root, here, capsys, cell)
    check_traced_run(root, here, cell, capsys)


def test_training_needs_a_reference_that_trains(monkeypatch):
    arch = types.ModuleType("benchmark.reference.untrained")
    arch.VQVAE, arch.latent_side, arch.tiny = nets.VQVAE, nets.latent_side, nets.tiny
    monkeypatch.setitem(sys.modules, arch.__name__, arch)
    cfg = dict(tiny.tiny_config("gumbel_vqgan"), reference="untrained")
    assert flops.detokenize_flops_per_image(cfg) > 0
    with pytest.raises(ValueError, match="no training reference"):
        flops.train_step_flops(cfg, 4, r1=False)
