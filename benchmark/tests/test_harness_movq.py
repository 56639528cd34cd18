"""The MoVQ decoding cell (``kandinsky22_movq.detokenize_b8``) at the tiny
size on the CPU, traced: its span metrics read from the port's
``spatial_norm``, ``attn``, ``decoder`` and ``api.*`` spans, and its spans
a request; ``spatial_norm_bound_pct`` (``device_trace``) read from the
window's spans and the trace's kernel times alone; and the readers of the
new metrics find nothing where the program opens no ``spatial_norm`` span
(the taming cell's run)."""

from __future__ import annotations

import json

from benchmark import run
from benchmark.flops import PEAK_HBM_BYTES_PER_S
from benchmark.tests import tiny
from benchmark.trace import Trace

CELL = "kandinsky22_movq.detokenize_b8"
SPAN = ("spatial_norm_ms", "attn_ms.kandinsky22_movq", "decoder_ms.kandinsky22_movq",
        "decode_host_ms.kandinsky22_movq")
NEW = ("spatial_norm_ms", "spatial_norm_bound_pct", "attn_ms.kandinsky22_movq")
# kernel names as the profiler gives them on the card, shortened
GN = "void (anonymous namespace)::gn_nhwc_apply_kernel<__nv_bfloat16, 8>(...)"
ADDCMUL = ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<"
           "at::native::addcmul_cuda_kernel(at::TensorIteratorBase&, c10::Scalar const&)>(...)")
SILU = ("void at::native::vectorized_elementwise_kernel<8, at::native::(anonymous namespace)::"
        "silu_kernel(at::TensorIteratorBase&)>(...)")
CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64"


def traced(root, here, capsys, cell: str) -> dict:
    assert run.main(["--workload", cell, "--seed", str(2 ** 31 + 11), "--seconds", "0.3",
                     "--trace", "1"], root=root, here=here, allow_cpu=True) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_the_cells_tiny_traced_run_reads_its_metrics(tmp_path, capsys):
    """The benchmark's MoVQ cell at the tiny size on the CPU, traced:
    correct, its span metrics read and above 0, 16 ``spatial_norm`` calls
    (the tiny decoder's) a request; ``spatial_norm_bound_pct`` absent (the
    CPU's trace holds no device kernel), and on the window's spans with a
    card's kernel times, 100 x their least seconds over the GroupNorm,
    addcmul and SiLU kernels' seconds, whatever the convs took."""
    from benchmark.metrics._norm_bytes import least_seconds
    from vqvae_tpu_torch.utils.introspect import span_log
    root, here = tiny.make(tmp_path, fp32=True)
    out = traced(root, here, capsys, CELL)
    assert out["correct"] is True, out["checks"]
    for name in SPAN:
        assert out["metrics"][name]["value"] > 0, name
    assert "spatial_norm_bound_pct" not in out["metrics"]
    spans = span_log()
    requests = [s for s in spans if s["parent"] is None]
    norms = [s for s in spans if s["name"] == "spatial_norm"]
    assert requests and len(norms) == 16 * len(requests)
    least = sum(least_seconds(s["attrs"]) for s in norms)
    assert least == sum((2 * s["attrs"]["elements"] + s["attrs"]["cond_elements"]) * 4
                        for s in norms) / PEAK_HBM_BYTES_PER_S
    images = sum(s["attrs"]["images"] for s in requests)
    for conv_s in (0.0, 5.0):
        trace = Trace(kind="detokenize", window_s=1.0, images=images,
                      kernels={GN: (13, 2 * least), ADDCMUL: (33, 1.5 * least),
                               SILU: (29, 0.5 * least), CONV: (100, conv_s)})
        assert abs(run.read_metric(here, "spatial_norm_bound_pct", trace) - 25.0) < 1e-9
    trace = Trace(kind="detokenize", window_s=1.0, images=images + 1, kernels={GN: (1, 1.0)})
    assert run.read_metric(here, "spatial_norm_bound_pct", trace) is None


def test_the_new_readers_find_nothing_without_spatial_norm_spans(tmp_path, capsys):
    """On a traced run of the taming cell (the same traffic kind, no
    SpatialNorm), as on a program that lacks the span: no value, no error."""
    from vqvae_tpu_torch.utils.introspect import span_log
    root, here = tiny.make(tmp_path, fp32=True)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append("taming_vqgan_f16.detokenize")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = traced(root, here, capsys, "taming_vqgan_f16.detokenize")
    assert span_log() and not any(s["name"] == "spatial_norm" for s in span_log())
    assert "attn_ms.kandinsky22_movq" in out["metrics"]
    assert "spatial_norm_ms" not in out["metrics"]
    assert "spatial_norm_bound_pct" not in out["metrics"]
