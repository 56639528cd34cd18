"""Discovery by name: every configuration, traffic mix, cell and per-layer
metric that ``BENCHMARK.json`` names has its file, found by that name, and
the file has what the harness reads from it; and the file keeps the
benchmark contract's shape."""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

import pytest
import yaml

from benchmark import reference, run

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MODEL_KEYS = ("image_size", "autoencoder", "quantizer", "loss", "training")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_published_yaml(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    path = ROOT / cfg["file"]
    assert path.parent == HERE / "configs" and path.name == f"{cfg['name']}.json"
    data = json.loads(path.read_text())
    published = yaml.safe_load((ROOT / "example_confs" / f"{cfg['name']}.yaml").read_text())
    assert {k: data.get(k) for k in published} == published
    assert data["reduced"] == cfg["reduced"]
    assert data["source"] == cfg["source"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


def check_cell_finds_its_files(root: Path, here: Path, name: str) -> None:
    """Cell ``name`` of ``root``'s BENCHMARK.json finds its configuration,
    its configuration's plain reference, its traffic's driver and its
    limits, and reports ``setup_s``, another end-to-end metric and a
    per-layer metric that moves one of them."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    _, _, config, traffic, limits = run.load_cell(root, here, name)
    assert config["name"] == cell["config"]
    arch = reference.of(config)
    assert arch.VQVAE and arch.latent_side(config) > 0 and arch.tiny(config)
    assert importlib.import_module(f"benchmark.cells.{traffic['kind']}").run
    assert limits, f"workloads/{name}.json holds no limits"
    reports = [m["name"] for m in bench["end_to_end"] if run._applies(m, name)]
    assert "setup_s" in reports and len(reports) >= 2
    per_layer = [m for m in bench["per_layer"] if run._applies(m, name)]
    assert per_layer and all(m["moves"] in reports for m in per_layer)


def check_names(bench: dict) -> None:
    """Pairs of configuration and traffic, and names, are unique and
    well formed."""
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for group in ("configs", "workloads"):
        names = [x["name"] for x in bench[group]]
        assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metrics)) == len(metrics) and all(NAME.match(n) for n in metrics)


def check_per_layer_metric(here: Path, bench: dict, metric: dict) -> None:
    """A per-layer metric is well formed, moves an end-to-end metric, lists
    cells that exist, and has a reader that finds nothing in an empty
    trace of any traffic kind (``cells/<kind>.py``)."""
    from benchmark.trace import Trace
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in ("host_clock", "device_trace", "program_span",
                                "program_counter")
    assert metric["moves"] in {m["name"] for m in bench["end_to_end"]}
    assert (here / "metrics" / f"{metric['name']}.py").exists()
    cells = {w["name"] for w in bench["workloads"]}
    assert set(metric["workloads"]) <= cells
    for driver in sorted((HERE / "cells").glob("[!_]*.py")):
        empty = Trace(kind=driver.stem, window_s=1.0)
        assert run.read_metric(here, metric["name"], empty) is None, (metric["name"], driver)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_files(cell):
    check_cell_finds_its_files(ROOT, HERE, cell["name"])


def test_pairs_and_names_are_unique():
    check_names(BENCH)


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader(metric):
    check_per_layer_metric(HERE, BENCH, metric)


def test_a_reader_that_finds_nothing_returns_nothing():
    from benchmark.trace import Trace
    empty = Trace(kind="train", window_s=1.0)
    for metric in BENCH["per_layer"]:
        assert run.read_metric(HERE, metric["name"], empty) is None, metric["name"]


def test_a_new_cell_is_only_files(tmp_path):
    """A cell, traffic mix and configuration added as files and entries is
    found without an edit to any file the benchmark has."""
    from benchmark.tests import tiny
    root, here = tiny.make(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((here / "configs" / "ema_vqvae.json").read_text())
    cfg["name"] = "ema_vqvae_small"
    (here / "configs" / "ema_vqvae_small.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "tokenize.json").read_text())
    (here / "traffic" / "tokenize_b2.json").write_text(json.dumps(dict(traffic, batch=2)))
    (here / "workloads" / "ema_vqvae_small.tokenize_b2.json").write_text(
        json.dumps({"limits": {"code_gap": 1.0}}))
    bench["workloads"].append({"name": "ema_vqvae_small.tokenize_b2", "config": "ema_vqvae_small",
                               "traffic": "tokenize_b2", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _, cell, config, traffic, limits = run.load_cell(root, here, "ema_vqvae_small.tokenize_b2")
    assert config["name"] == "ema_vqvae_small" and traffic["batch"] == 2
    assert limits == {"code_gap": 1.0}
