"""A tiny copy of the benchmark for CPU tests: every configuration's model
cut by its plain reference's ``tiny`` (``nets``: 16^2 images, 32 channels,
multipliers [1, 2], 16 codes of 8 dims), its discriminator to channel_base
256, every traffic mix to batches of 4 and windows of a few steps.
``make(tmp_path)`` writes it and returns (root, here) for
``benchmark.run.main``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import reference

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent


def tiny_config(name: str) -> dict:
    """Configuration ``name`` with its model cut by its reference's ``tiny``,
    and its discriminator, assumed batch and steps per epoch cut here."""
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg = reference.of(cfg).tiny(cfg)
    if cfg.get("loss"):
        cfg["discriminator"] = {"channel_base": 256}
    cfg["assumed"] = dict(cfg["assumed"], batch_images=4, steps_per_epoch=10)
    return cfg


def tiny_traffic(name: str, fp32: bool = False) -> dict:
    t = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    t["batch"] = 4
    t["pool"] = min(t["pool"], 4)
    if fp32:
        t["precision"] = "fp32"
    return t


def make(tmp_path: Path, limits: dict | None = None, fp32: bool = False):
    """-> (root, here): BENCHMARK.json in ``root``, the tiny files in
    ``here``; ``limits`` {cell: {number: limit}} (default: the real ones);
    ``fp32``: every traffic mix in the reference's own precision, where a
    sound run agrees with it to rounding."""
    root, here = tmp_path, tmp_path / "bench"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for sub in ("configs", "traffic", "workloads"):
        (here / sub).mkdir(parents=True)
    shutil.copytree(HERE / "metrics", here / "metrics")
    for c in bench["configs"]:
        (here / "configs" / f"{c['name']}.json").write_text(json.dumps(tiny_config(c["name"])))
    for w in bench["workloads"]:
        (here / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(tiny_traffic(w["traffic"], fp32)))
        real = HERE / "workloads" / f"{w['name']}.json"
        lim = (limits or {}).get(w["name"])
        if lim is None and real.exists():
            lim = json.loads(real.read_text())["limits"]
        if lim is not None:
            (here / "workloads" / f"{w['name']}.json").write_text(json.dumps({"limits": lim}))
    return root, here
