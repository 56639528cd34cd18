"""The port's spans (``vqvae_tpu_torch.utils.introspect.named_scope`` and its
span log) on the CPU, on the 16^2 gumbel-VQGAN of
``tests/test_torch_bench_tools.py`` (``bench_breakdown.make_cfg``'s
``gan_r1`` cut to channels 32, one residual block, N 32, D 8; a narrow D):

- with no capture running, a train step and both API calls record nothing,
  make no CUDA event and open no record function, and their outputs and
  every leaf's gradient equal, bit for bit, those of runs with
  ``named_scope`` stubbed to a no-op;
- under a CPU ``torch.profiler`` capture, an R1 step and a plain step give
  the span tree the training step's phases make (one ``id`` per step,
  ``gan.r1_grad`` on the R1 step only, ``norm_act`` inside ``encoder`` and
  ``decoder``), and ``api.get_tokens`` / ``api.reconstruct_from_tokens``
  give their children;
- spans that remat recomputes in the backward hang under ``ae.backward``
  and leave the calling thread's stack empty; a span opened on another
  thread hangs under the running one;
- ``introspect.trace`` writes the spans' record-function events in its
  Chrome trace and the span log beside it; the log starts afresh at each
  capture and stays bounded, and a closed span's entry is a tuple that the
  cyclic GC no longer tracks;
- on the card (``cuda``): every capture takes its spans' events from one
  warmed pool, each span's device interval is its own, and a span left open
  from an older capture does not re-record an event a newer one holds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import threading
from pathlib import Path

import pytest
import torch

from vqvae_tpu_torch import bench_breakdown
from vqvae_tpu_torch.models import autoencoder, lpips, vqvae
from vqvae_tpu_torch.train import loop, steps
from vqvae_tpu_torch.train.loop import Trainer
from vqvae_tpu_torch.utils import introspect

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
BATCH = 4
PHASES = ["gan.d_real", "gan.r1_grad", "gan.d_real_backward", "ae.forward", "lpips",
          "gan.d_fake", "gan.d_fake_backward", "ae.backward", "optim", "usage"]
SPAN_SITES = (steps, loop, autoencoder, vqvae, lpips)


def tiny_cfg():
    cfg = bench_breakdown.make_cfg(16, 32, **bench_breakdown.VARIANTS["gan_r1"])
    return dataclasses.replace(
        cfg, autoencoder=dataclasses.replace(cfg.autoencoder, num_res_blocks=1,
                                             channel_multipliers=(1, 2)),
        quantizer=dataclasses.replace(cfg.quantizer, num_embeddings=32, embedding_dim=8))


def make_trainer(monkeypatch, tmp_path, remat: bool = False):
    monkeypatch.setenv("VQVAE_TPU_LPIPS_WEIGHTS_DIR", str(tmp_path / "lpips"))
    with pytest.warns(UserWarning, match="LPIPS"):
        trainer = Trainer(tiny_cfg(), learning_rate=1e-4, seed=0, steps_per_epoch=1000,
                          device="cpu", remat=remat, disc_kwargs={"channel_base": 256})
    return trainer, trainer.init_state()


def batch(seed: int = 0) -> dict:
    return {"image": torch.randint(0, 256, (BATCH, 16, 16, 3), dtype=torch.uint8,
                                   generator=torch.Generator().manual_seed(seed))}


def r1_then_plain(trainer, state) -> list:
    """An R1 step (host step 0), then a plain one; -> their metrics."""
    trainer.host_step = 0
    out = []
    for i in range(2):
        assert trainer.r1_due(0) == (i == 0)
        out.append(trainer.train_step(state, batch(i), epoch=0)[1])
    return out


def api_calls(model) -> tuple:
    images = batch(5)["image"].float() / 255.0
    tokens = model.get_tokens(images, deterministic=True)
    return tokens, model.reconstruct_from_tokens(tokens)


def by_name(spans: list, name: str) -> list:
    return [s for s in spans if s["name"] == name]


def children(spans: list, parent: dict) -> list:
    return [s["name"] for s in spans if s["parent"] == parent["index"]]


def ancestors(spans: list, span: dict) -> list:
    out, parent = [], span["parent"]
    while parent is not None:
        out.append(spans[parent]["name"])
        parent = spans[parent]["parent"]
    return out


@pytest.fixture
def captured():
    """A CPU capture: -> a function that runs ``fn`` inside one and returns
    its result and the span log."""
    def run(fn):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            out = fn()
        return out, introspect.span_log()
    return run


def test_no_capture_records_nothing_and_changes_nothing(monkeypatch, tmp_path):
    trainer, state = make_trainer(monkeypatch, tmp_path)
    log, captures = introspect._LOG.entries, introspect._LOG.captures

    def refuse(*args, **kwargs):
        raise AssertionError("a span recorded with no capture running")

    with monkeypatch.context() as m:
        m.setattr(introspect, "_RecordFunctionFast", refuse)
        m.setattr(torch.cuda, "Event", refuse)
        m.setattr(introspect._LOG, "open", refuse)
        metrics = r1_then_plain(trainer, state)
        grads = {k: p.grad.clone() for k, p in
                 list(state.model.named_parameters()) + list(state.disc.named_parameters())
                 if p.grad is not None}
        api = api_calls(state.model)
    assert introspect._LOG.entries is log and introspect._LOG.captures == captures

    stub_trainer, stub_state = make_trainer(monkeypatch, tmp_path)
    for module in SPAN_SITES:
        monkeypatch.setattr(module, "named_scope",
                            lambda *a, **k: contextlib.nullcontext(), raising=True)
    stub_metrics = r1_then_plain(stub_trainer, stub_state)
    stub_api = api_calls(stub_state.model)
    for got, want in zip(metrics, stub_metrics):
        assert got.keys() == want.keys()
        for k in got:
            assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(want[k])), k
    stub_params = dict(list(stub_state.model.named_parameters())
                       + list(stub_state.disc.named_parameters()))
    assert grads and all(torch.equal(g, stub_params[k].grad) for k, g in grads.items())
    assert all(torch.equal(a, b) for a, b in zip(api, stub_api))


def test_disabled_scope_is_shared_and_decorates():
    assert introspect.named_scope("norm_act") is introspect.named_scope("norm_act")

    @introspect.named_scope("decorated", images=3)
    def f(x):
        return x + 1

    assert f(1) == 2
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert f(2) == 3
    (span,) = introspect.span_log()
    assert (span["name"], span["attrs"], span["parent"]) == ("decorated", {"images": 3}, None)


def test_r1_and_plain_steps_give_the_span_tree(monkeypatch, tmp_path, captured):
    trainer, state = make_trainer(monkeypatch, tmp_path)
    _, spans = captured(lambda: r1_then_plain(trainer, state))
    assert [s["index"] for s in spans] == list(range(len(spans)))
    tops = [s for s in spans if s["parent"] is None]
    assert [(s["name"], s["id"], s["attrs"]["r1"], s["attrs"]["images"]) for s in tops] == \
        [("train.step", 0, True, BATCH), ("train.step", 1, False, BATCH)]
    for top, want in zip(tops, (PHASES, [p for p in PHASES if p != "gan.r1_grad"])):
        assert children(spans, top) == want
        (forward,) = [s for s in spans if s["parent"] == top["index"]
                      and s["name"] == "ae.forward"]
        assert children(spans, forward) == ["encoder", "quantizer", "decoder"]
    assert len(by_name(spans, "gan.r1_grad")) == 1
    assert by_name(spans, "gan.r1_grad")[0]["id"] == 0
    for s in spans:
        top = tops[s["id"]]
        assert s["host_ms"] >= 0 and s["device_ms"] >= 0
        assert top["host_start_ns"] <= s["host_start_ns"] <= s["host_end_ns"] \
            <= top["host_end_ns"]
        if s["parent"] is not None:
            assert spans[s["parent"]]["id"] == s["id"]
    norm_act = by_name(spans, "norm_act")
    assert norm_act and {spans[s["parent"]]["name"] for s in norm_act} == {"encoder",
                                                                           "decoder"}
    # the encoder: 1 + 2 blocks x 2 pairs and its own norm; the decoder alike
    assert len(norm_act) == 2 * 2 * 7


def test_api_calls_give_their_children(monkeypatch, tmp_path, captured):
    _, state = make_trainer(monkeypatch, tmp_path)
    (tokens, images), spans = captured(lambda: api_calls(state.model))
    get, recon = [s for s in spans if s["parent"] is None]
    assert (get["name"], get["attrs"], get["id"]) == ("api.get_tokens", {"images": BATCH}, 0)
    assert (recon["name"], recon["attrs"], recon["id"]) == (
        "api.reconstruct_from_tokens", {"images": BATCH}, 1)
    assert children(spans, get) == ["encoder", "quantizer"]
    assert children(spans, recon) == ["quantizer.lookup", "decoder"]
    assert all(ancestors(spans, s)[-1].startswith("api.") for s in by_name(spans, "norm_act"))
    assert tokens.shape == (BATCH, 16) and images.shape == (BATCH, 16, 16, 3)


def test_taming_attention_blocks_give_attn_spans(captured):
    """The taming layout at 16^2 with attention at 8^2 (the benchmark
    reference's tiny copy): ``attn`` spans (attribute ``positions``) hang
    right under ``encoder`` (its second level and middle: 2) and under
    ``decoder`` (its middle and the first level's two blocks: 3), and
    ``norm_act`` still wraps every GroupNorm -> SiLU pair but the
    attention's, whose GroupNorm has no SiLU."""
    from benchmark.reference import taming
    from vqvae_tpu_torch.config import parse_config
    cfg = taming.tiny(json.loads((ROOT / "benchmark" / "configs"
                                  / "taming_vqgan_f16.json").read_text()))
    model = vqvae.VQVAE.from_config(
        parse_config({k: cfg[k] for k in ("image_size", "autoencoder", "quantizer")}),
        device="cpu", generator=torch.Generator().manual_seed(0))
    (tokens, images), spans = captured(lambda: api_calls(model))
    attn = by_name(spans, "attn")
    assert [spans[s["parent"]]["name"] for s in attn] == ["encoder"] * 2 + ["decoder"] * 3
    assert all(s["attrs"] == {"positions": 64} for s in attn)
    assert all(children(spans, s) == [] for s in attn)
    # two pairs per residual block, and norm_out: the encoder's 2 levels' and
    # middle's 4 blocks, the decoder's middle's 2 and 2 levels' 4
    assert [spans[s["parent"]]["name"] for s in by_name(spans, "norm_act")] == \
        ["encoder"] * 9 + ["decoder"] * 13
    assert tokens.shape == (BATCH, 64) and images.shape == (BATCH, 16, 16, 3)


def test_movq_spatial_norms_give_spatial_norm_spans(captured):
    """MoVQ's decoder (the benchmark reference's tiny copy: attention at
    8^2): each SpatialNorm call opens one ``spatial_norm`` span (attributes
    ``elements``, ``element_bytes``, ``cond_elements``, ``act``) and counts one ``spatial_norm.calls``, 16 a decode (the middle
    block's 5, the first level's 2 blocks x 2 and 2 attention blocks', the
    second level's 4 and ``norm_out``), the attention blocks' inside
    ``attn`` without the SiLU; the decoder opens no ``norm_act`` span, the
    encoder (taming's) no ``spatial_norm`` span; a taming decode counts
    none."""
    from benchmark.reference import movq, taming
    from vqvae_tpu_torch.config import parse_config

    def model(name, tiny):
        cfg = tiny(json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text()))
        return vqvae.VQVAE.from_config(
            parse_config({k: cfg[k] for k in ("image_size", "autoencoder", "quantizer")}),
            device="cpu", generator=torch.Generator().manual_seed(0))

    movq_model = model("kandinsky22_movq", movq.tiny)
    calls = autoencoder.spatial_norm.calls
    (tokens, images), spans = captured(lambda: api_calls(movq_model))
    assert autoencoder.spatial_norm.calls - calls == 16
    norms = by_name(spans, "spatial_norm")
    assert [spans[s["parent"]]["name"] for s in norms] == \
        ["decoder"] * 2 + ["attn"] + ["decoder"] * 4 + ["attn"] + ["decoder"] * 2 + ["attn"] + \
        ["decoder"] * 5
    assert all(ancestors(spans, s)[-1] == "api.reconstruct_from_tokens" for s in norms)
    assert [s["attrs"]["act"] for s in norms if spans[s["parent"]]["name"] == "attn"] == \
        [False] * 3
    first = norms[0]["attrs"]
    assert first == {"elements": BATCH * 64 * 8 * 8, "element_bytes": 4,
                     "cond_elements": BATCH * 4 * 8 * 8, "act": True}
    assert norms[-1]["attrs"]["elements"] == BATCH * 32 * 16 * 16
    assert {spans[s["parent"]]["name"] for s in by_name(spans, "norm_act")} == {"encoder"}
    assert tokens.shape == (BATCH, 64) and images.shape == (BATCH, 16, 16, 3)
    taming_model = model("taming_vqgan_f16", taming.tiny)
    calls = autoencoder.spatial_norm.calls
    captured(lambda: api_calls(taming_model))
    assert autoencoder.spatial_norm.calls == calls


def test_remat_recomputed_spans_keep_the_stack(monkeypatch, tmp_path, captured):
    trainer, state = make_trainer(monkeypatch, tmp_path, remat=True)
    trainer.host_step = 1   # a plain step
    _, spans = captured(lambda: trainer.train_step(state, batch(), epoch=0))
    assert introspect._LOG._stack() == []
    assert all(s["host_end_ns"] is not None for s in spans)
    recomputed = [s for s in spans if s["name"] == "norm_act"
                  and "ae.backward" in ancestors(spans, s)]
    # every residual block's two pairs again (3 blocks per side), none of
    # the modules' own last norm (not checkpointed)
    assert len(recomputed) == 2 * 3 * 2
    assert {s["id"] for s in spans} == {0}


def test_a_span_on_another_thread_hangs_under_the_running_one(captured):
    seen = {}

    def worker():
        with introspect._Span("worker", {}):
            seen["stack"] = list(introspect._LOG._stack())

    def body():
        with introspect.named_scope("outer", images=1):
            with introspect.named_scope("inner"):
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
                seen["main"] = [s.name for s in introspect._LOG._stack()]

    _, spans = captured(body)
    assert [(s["name"], s["parent"], s["id"]) for s in spans] == [
        ("outer", None, 0), ("inner", 0, 0), ("worker", 1, 0)]
    assert seen["main"] == ["outer", "inner"]
    assert [s.name for s in seen["stack"]] == ["worker"]
    assert introspect._LOG._stack() == []


def test_trace_writes_the_chrome_trace_and_the_span_log(monkeypatch, tmp_path):
    _, state = make_trainer(monkeypatch, tmp_path)
    with introspect.trace(str(tmp_path / "trace")):
        api_calls(state.model)
    (chrome,) = (tmp_path / "trace").glob("trace_*.json")
    (log,) = (tmp_path / "trace").glob("spans_*.json")
    assert log.name.removeprefix("spans_") == chrome.name.removeprefix("trace_")
    written = json.loads(log.read_text())
    names = [s["name"] for s in written["spans"]]
    assert written["dropped"] == 0 and names[0] == "api.get_tokens"
    events = {e.get("name") for e in json.loads(chrome.read_text())["traceEvents"]}
    assert set(names) <= events


def test_the_log_starts_afresh_and_stays_bounded(monkeypatch, tmp_path, captured):
    def spans(n):
        for i in range(n):
            with introspect.named_scope("s", images=i):
                pass

    _, first = captured(lambda: spans(3))
    _, second = captured(lambda: spans(2))
    assert [s["attrs"]["images"] for s in first] == [0, 1, 2]
    assert [(s["attrs"]["images"], s["id"]) for s in second] == [(0, 0), (1, 1)]
    monkeypatch.setattr(introspect._LOG, "limit", 5)
    _, bounded = captured(lambda: spans(8))
    assert len(bounded) == 5 and introspect.spans_dropped() == 3
    _, after = captured(lambda: spans(1))
    assert len(after) == 1 and introspect.spans_dropped() == 0
    # a capture that records no span writes an empty log beside its trace
    with introspect.trace(str(tmp_path / "empty")):
        pass
    (log,) = (tmp_path / "empty").glob("spans_*.json")
    assert json.loads(log.read_text()) == {"dropped": 0, "spans": []}


def test_profile_tokenizer_prints_device_time_by_span(monkeypatch, tmp_path, captured,
                                                      capsys):
    from vqvae_tpu_torch import profile_tokenizer
    _, state = make_trainer(monkeypatch, tmp_path)
    calls = profile_tokenizer.CALLS
    images = batch()["image"].float() / 255.0
    _, spans = captured(lambda: [state.model.get_tokens(images) for _ in range(calls)])
    capsys.readouterr()
    profile_tokenizer.report_spans(spans)
    lines = capsys.readouterr().out.splitlines()
    assert [line.split("span ")[1] for line in lines] == [
        "api.get_tokens", "api.get_tokens/encoder", "api.get_tokens/encoder/norm_act",
        "api.get_tokens/quantizer"]
    assert "7.0x" in lines[2]
    profile_tokenizer.report_spans(spans[:1])   # one call of CALLS: not this window's log
    assert capsys.readouterr().out.strip() == "(no span log of this window)"


def test_closed_spans_leave_nothing_for_the_gc(captured):
    def spans():
        for i in range(50):
            with introspect.named_scope("outer", images=i):
                with introspect.named_scope("inner"):
                    pass
    captured(spans)
    gc.collect()
    rows = list(introspect._LOG.entries)
    assert len(rows) == 100 and all(isinstance(r, tuple) for r in rows)
    assert not any(gc.is_tracked(r) for r in rows)


@pytest.mark.cuda
def test_captures_reuse_the_warmed_event_pool():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.ones(2048, 2048, device="cuda")
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def work(n):
        for _ in range(n):
            x @ x

    def capture(stale=None):
        with torch.profiler.profile(activities=activities):
            with introspect.named_scope("outer", images=1):
                with introspect.named_scope("inner"):
                    work(20)
            if stale is not None:   # closed after more work, under the next capture
                work(200)
                stale.__exit__(None, None, None)
        return introspect.span_log()

    work(1)   # cuBLAS's set-up, outside the timed spans
    torch.cuda.synchronize()
    device = torch.cuda.current_device()
    outer, inner = capture()
    pool = list(introspect._LOG._events[device])
    assert len(pool) >= introspect.WARM_EVENTS
    event = introspect.SpanLog.ROW.index("event")
    assert [introspect._LOG.entries[i][event] for i in range(2)] == [0, 2]
    assert 0 < inner["device_ms"] <= outer["device_ms"]
    with torch.profiler.profile(activities=activities):
        stale = introspect.named_scope("stale")
        stale.__enter__()   # takes the pool's first two events
    outer2, inner2 = capture(stale)
    assert introspect._LOG._events[device][:len(pool)] == pool
    assert [introspect._LOG.entries[i][event] for i in range(2)] == [0, 2]
    assert (outer2["name"], inner2["name"]) == ("outer", "inner")
    assert outer2["device_ms"] < 2 * outer["device_ms"], (outer, outer2)
