"""The serving tools of the port on the CPU, at small sizes:
``vqvae_tpu_torch.bench_infer`` prints one JSON line with three positive
rates, ``vqvae_tpu_torch.probe_max_resolution`` one line per resolution
tried and its ceiling, and ``utils.introspect.trace`` writes a Chrome trace
that holds a ``named_scope``'s span. Without a card both tools refuse
``--device cuda``, their default.
"""

import json

import pytest
import torch

from vqvae_tpu_torch import bench_infer, probe_max_resolution
from vqvae_tpu_torch.utils.introspect import named_scope, trace

torch.set_num_threads(2)


def test_bench_infer_prints_one_json_line(monkeypatch, capsys):
    monkeypatch.setenv("VQGAN_INFER_BATCH", "2")
    monkeypatch.setenv("VQGAN_INFER_STEPS", "2")
    record = bench_infer.main(["--device", "cpu"])
    (line,) = capsys.readouterr().out.strip().splitlines()
    assert json.loads(line) == record
    assert record["metric"] == bench_infer.METRIC and record["batch"] == 2
    assert all(record[k] > 0 for k in ("tokenize_ips", "reconstruct_ips", "detokenize_ips"))
    assert record["device"] == "cpu" and record["card"] is None
    assert record["dtype"] == "bfloat16"


def test_probe_prints_a_line_per_resolution(capsys):
    rows = probe_max_resolution.main(["--device", "cpu", "--start", "32", "--max", "64",
                                      "--channels", "32"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [r["res"] for r in rows] == [32, 64] and all(r["ok"] for r in rows)
    assert [r["tokens"] for r in rows] == [(1, 4), (1, 16)]
    assert lines[0].startswith("res=32: OK") and lines[1].startswith("res=64: OK")
    assert "peak not measured" in lines[0]
    assert lines[2].endswith("cpu): 64")
    assert rows[1]["jax_estimate_gb"] == 4 * 64 * 64 * 32 * 2 / 1e9
    assert rows[1]["port_estimate_gb"] == 5 * 4 * 64 * 64 * 32 / 1e9


@pytest.mark.parametrize("tool", [bench_infer, probe_max_resolution])
def test_tools_ask_for_the_card_by_default(tool):
    assert tool.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.main([])


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "trace")):
        with named_scope("vq_lookup"):
            torch.cdist(torch.randn(64, 8), torch.randn(16, 8)).argmin(1)
    (path,) = (tmp_path / "trace").glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "vq_lookup" for e in events)
