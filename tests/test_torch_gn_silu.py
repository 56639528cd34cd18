"""The GroupNorm -> SiLU kernel's plain version, its dispatch and, on the
card, the kernel (``vqvae_tpu_torch/ops/gn_silu.py``, ``gn_silu_cuda.py``,
``csrc/gn_silu.cu``).

On the CPU:
- ``gn_silu_reference`` (and ``gn_silu``, which takes it for CPU tensors)
  equals, bit for bit, the op sequence ``GroupNorm`` and ``norm_act`` ran
  before the kernel, for both variances, bf16 and fp32 outputs, with the
  SiLU on and off; and, in fp32 with the unbiased variance, the JAX
  package's ``_gn_silu_plain`` (NHWC there) within 1e-5 (sums in other
  orders);
- ``norm_act`` and the attention's GroupNorm go to ``gn_silu`` wherever
  autograd does not record and no sharded call runs, whatever the input's
  layout; elsewhere the module's form runs, ``gn_silu.launches`` does not
  move and gradients flow; ``gn_silu`` refuses an input in another dtype
  than the module's; a training step calls it never, an eval
  step at every pair; each pair opens exactly one ``norm_act`` span;
- ``plan`` picks the cluster form with 16-byte accesses at every shape of
  the three benchmark configurations, the two-pass form where a group fits
  no cluster, and one element an access on ragged shapes; ``plan_nhwc``
  the NHWC grid form at the decoders' shapes and its two-pass form, over
  bands that fill 32-byte sectors, elsewhere; the wrapper's constants are the source's and it rejects
  what the kernel does not take; the plain version returns its input's
  memory format, and the bf16 decoders send every call channels-last.

On the card (``cuda``), the kernel against the plain version at every
``norm_act`` and attention-norm shape of the three configurations (batch 2,
and the cells' batches at 256^2), at ragged and misaligned shapes, in the
two-pass form, on inputs whose mean is 50 times their spread and on a
tensor of more than 2^31 elements (``kernel_error`` of ``gn_silu_check.py``:
the GroupNorm within one bf16 ulp, or 4e-6 in fp32, of the affine's scale;
with the SiLU, ``F.silu`` of the kernel's own GroupNorm bit for bit); two
launches bit-identical; the same for the NHWC form on channels-last inputs
at the decoders' shapes, ragged, misaligned and two-pass; a channels-last
input takes the NHWC form as it lies, another non-contiguous one the
kernel on a copy; the launches and NHWC calls of a call (two launches in
the two-pass form) and of a training step.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from gn_silu_check import FP32_LIMIT, kernel_error

from vqvae_tpu_torch import bench_breakdown
from vqvae_tpu_torch.config import load_config
from vqvae_tpu_torch.models import autoencoder, vqvae
from vqvae_tpu_torch.models.autoencoder import GroupNorm, norm_act
from vqvae_tpu_torch.ops import _build
from vqvae_tpu_torch.ops import gn_silu as gs
from vqvae_tpu_torch.ops import gn_silu_cuda as gsc
from vqvae_tpu_torch.train.loop import Trainer
from vqvae_tpu_torch.utils import introspect

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
H100_SMS = 132


def module_form(x, weight, bias, num_groups, eps, ddof, dtype, act):
    """``GroupNorm.forward`` and ``norm_act`` as the port ran them before the
    kernel, copied op for op."""
    b, c, h, w = x.shape
    g = num_groups
    n = (c // g) * h * w
    xg = x.float().reshape(b, g, n)
    mean = xg.mean(-1, keepdim=True)
    centered = xg - mean
    squares = (centered * centered).sum(-1, keepdim=True)
    var = squares / max(n - ddof, 1)
    xf = (centered * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    out = (xf * weight + bias).to(dtype)
    return F.silu(out) if act else out


def _norm(c, dtype, ddof, seed=0):
    norm = GroupNorm(c, dtype=dtype, unbiased=bool(ddof))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.5 * torch.randn(norm.weight.shape, generator=gen))
        norm.bias.copy_(0.5 * torch.randn(norm.bias.shape, generator=gen))
    return norm


def _input(shape, dtype, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return (3 + 2 * torch.randn(shape, generator=gen)).to(dtype)


@pytest.mark.parametrize("act", [True, False], ids=["silu", "norm"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("ddof", [1, 0], ids=["unbiased", "biased"])
def test_plain_version_is_the_module_form_bit_for_bit(ddof, dtype, act):
    norm = _norm(64, dtype, ddof)
    x = _input((2, 64, 6, 10), dtype)
    want = module_form(x, norm.weight, norm.bias, 32, 1e-6, ddof, dtype, act)
    args = (x, norm.weight, norm.bias, 32, 1e-6, ddof, dtype, act)
    with torch.no_grad():
        assert torch.equal(gs.gn_silu_reference(*args), want.detach())
        assert torch.equal(gs.gn_silu(*args), want.detach())
        got = norm_act(norm, x) if act else norm(x)
    assert got.dtype == dtype and torch.equal(got, want.detach())
    # under autograd, the module's form: the same bits
    assert torch.equal(norm_act(norm, x) if act else norm(x), want)


@pytest.mark.parametrize("act", [True, False], ids=["silu", "norm"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_plain_version_returns_its_inputs_memory_format(dtype, act):
    norm = _norm(64, dtype, 0)
    x = _input((2, 64, 6, 10), dtype)
    args = (norm.weight, norm.bias, 32, 1e-6, 0, dtype, act)
    want = gs.gn_silu_reference(x, *args)
    got = gs.gn_silu_reference(x.contiguous(memory_format=torch.channels_last), *args)
    assert want.is_contiguous() and gs.channels_last(got)
    assert torch.equal(got, want)


def test_plain_version_matches_the_jax_package():
    import jax.numpy as jnp

    from vqvae_tpu.models.autoencoder import _gn_silu_plain
    rs = np.random.RandomState(3)
    x = (1.5 + 2 * rs.randn(2, 12, 10, 64)).astype(np.float32)    # NHWC
    scale = (1 + 0.5 * rs.randn(64)).astype(np.float32)
    bias = (0.5 * rs.randn(64)).astype(np.float32)
    want = np.asarray(_gn_silu_plain(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32,
                                     1e-6, jnp.float32)[0])
    got = gs.gn_silu_reference(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                               torch.from_numpy(scale).reshape(1, -1, 1, 1),
                               torch.from_numpy(bias).reshape(1, -1, 1, 1), 32, 1e-6, 1,
                               torch.float32)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=1e-5, atol=1e-5)


class _Spy:
    """Stands in for ``autoencoder.gn_silu``: counts the calls by ``act``
    and by the input's layout (channels-last or not) and returns the plain
    version's result."""

    def __init__(self):
        self.calls = collections.Counter()
        self.layouts = collections.Counter()

    def __call__(self, x, weight, bias, num_groups, eps, ddof, dtype, act=True):
        self.calls[act] += 1
        self.layouts[gs.channels_last(x)] += 1
        return gs.gn_silu_reference(x, weight, bias, num_groups, eps, ddof, dtype, act)


@pytest.fixture
def spy(monkeypatch):
    s = _Spy()
    monkeypatch.setattr(autoencoder, "gn_silu", s)
    return s


class _OneShard:
    """A height-sharded call's ``shards`` on one process."""
    size = 1

    @staticmethod
    def sum(t):
        return t


def test_only_calls_autograd_does_not_record_take_the_kernel(spy):
    norm = _norm(64, torch.bfloat16, 1)
    x = _input((2, 64, 8, 8), torch.bfloat16)
    want = module_form(x, norm.weight, norm.bias, 32, 1e-6, 1, torch.bfloat16, True)
    launches = gs.gn_silu.launches
    with torch.no_grad():
        assert torch.equal(norm_act(norm, x), want.detach())
        assert spy.calls == {True: 1}
        norm(x)
        assert spy.calls == {True: 1, False: 1}
        # the layout does not choose the form
        assert torch.equal(norm_act(norm, x.contiguous(memory_format=torch.channels_last)),
                           want.detach())
        assert spy.calls == {True: 2, False: 1}
        norm.shards = _OneShard()
        assert torch.equal(norm_act(norm, x), want.detach())
        norm.shards = None
    assert spy.calls == {True: 2, False: 1}
    with torch.inference_mode():
        norm_act(norm, x)
    assert spy.calls == {True: 3, False: 1}
    # under autograd: the module's form, and gradients flow
    xg = x.float().requires_grad_()
    out = norm_act(norm, xg.to(torch.bfloat16))
    out.float().square().sum().backward()
    assert spy.calls == {True: 3, False: 1}
    assert torch.equal(out, want)
    grads = [xg.grad, norm.weight.grad, norm.bias.grad]
    assert all(g is not None and torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)
    assert gs.gn_silu.launches == launches


def test_kernel_dispatch_refuses_another_dtype():
    """``gn_silu`` raises on an input whose dtype is not the module's (the
    kernel writes the input's), on the CPU as off it; under autograd the
    module's form takes it."""
    norm = _norm(64, torch.bfloat16, 1)
    x = _input((2, 64, 4, 4), torch.float32)
    args = (norm.weight, norm.bias, 32, 1e-6, 1, torch.bfloat16)
    with torch.no_grad():
        for dev in ("cpu", "meta"):
            with pytest.raises(ValueError, match="dtype"):
                gs.gn_silu(x.to(dev), *args)
        with pytest.raises(ValueError, match="dtype"):
            norm_act(norm, x)
    assert norm_act(norm, x).dtype == torch.bfloat16


def tiny_cfg():
    cfg = bench_breakdown.make_cfg(16, 32, **bench_breakdown.VARIANTS["gan_r1"])
    return dataclasses.replace(
        cfg, autoencoder=dataclasses.replace(cfg.autoencoder, num_res_blocks=1,
                                             channel_multipliers=(1, 2)),
        quantizer=dataclasses.replace(cfg.quantizer, num_embeddings=32, embedding_dim=8))


def test_a_training_step_never_calls_it_and_an_eval_step_does(monkeypatch, tmp_path, spy):
    monkeypatch.setenv("VQVAE_TPU_LPIPS_WEIGHTS_DIR", str(tmp_path / "lpips"))
    with pytest.warns(UserWarning, match="LPIPS"):
        trainer = Trainer(tiny_cfg(), learning_rate=1e-4, seed=0, steps_per_epoch=1000,
                          device="cpu", disc_kwargs={"channel_base": 256})
    state = trainer.init_state()
    images = torch.randint(0, 256, (4, 16, 16, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    for host_step in (0, 1):   # an R1 step, then a plain one
        trainer.host_step = host_step
        trainer.train_step(state, {"image": images}, epoch=0)
    assert spy.calls == {}
    trainer.eval_step(state, {"image": images}, epoch=0)
    # the encoder's and the decoder's pairs: 2 in each of their 3 residual
    # blocks (one a level, one in the final / initial stage), and the closing pair
    assert spy.calls == {True: 2 * (2 * 3 + 1)}


def _taming_tiny(dtype=torch.float32):
    import json

    from benchmark.reference import taming
    from vqvae_tpu_torch.config import parse_config
    cfg = taming.tiny(json.loads((ROOT / "benchmark" / "configs"
                                  / "taming_vqgan_f16.json").read_text()))
    return vqvae.VQVAE.from_config(
        parse_config({k: cfg[k] for k in ("image_size", "autoencoder", "quantizer")}),
        dtype=dtype, device="cpu", generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_decoding_sends_bf16_calls_channels_last(spy, dtype):
    """Every call of a decode reaches ``gn_silu`` channels-last in bf16 (the
    NHWC form on the card) and contiguous NCHW in fp32."""
    tokens = torch.randint(0, 8, (2, 64), generator=torch.Generator().manual_seed(0))
    _taming_tiny(dtype).reconstruct_from_tokens(tokens)
    assert spy.layouts == {dtype == torch.bfloat16: 13 + 3}


def test_each_pair_opens_one_norm_act_span(spy):
    model = _taming_tiny()
    tokens = torch.randint(0, 8, (2, 64), generator=torch.Generator().manual_seed(0))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        model.reconstruct_from_tokens(tokens)
    spans = introspect.span_log()
    pairs = [s for s in spans if s["name"] == "norm_act"]
    # the tiny decoder: the middle's 2 blocks and 2 levels' 4, 2 pairs each,
    # and norm_out; its 3 attention blocks' GroupNorm without the SiLU
    assert len(pairs) == spy.calls[True] == 13
    assert spy.calls[False] == 3
    assert all(spans[s["parent"]]["name"] == "decoder" for s in pairs)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_kernel_error_measures_in_ulps_at_the_affines_scale(dtype):
    """``kernel_error`` reads 0 on the plain version's own outputs, one ulp
    (bf16) or ``FP32_LIMIT`` (fp32) of the scale for an output moved by that
    much, more past it, and inf where the SiLU output is not ``F.silu`` of
    the GroupNorm's. The bf16 scale holds no |mean| term: at mean 50,
    std 1, an output moved by a few ulps is refused."""
    norm = _norm(64, dtype, 1)
    x = _input((2, 64, 6, 10), dtype)
    args = (x, norm.weight, norm.bias, 32, 1e-6, 1)
    with torch.no_grad():
        plain = gs.gn_silu_reference(*args, dtype, act=False)
        assert kernel_error(*args, plain, F.silu(plain)) == 0
        # one element moved: by an ulp of the scale (bf16), or by more than
        # the limit (fp32); the scale is at least |plain|
        moved = plain.clone().flatten()
        k = int(moved.float().abs().argmax())
        if dtype == torch.bfloat16:
            moved[k] = (moved[k:k + 1].view(torch.int16) + 1).view(torch.bfloat16)[0]
            assert kernel_error(*args, moved.view_as(plain), F.silu(moved.view_as(plain))) <= 1
        else:
            moved[k] = moved[k] * (1 + 10 * FP32_LIMIT)
            assert kernel_error(*args, moved.view_as(plain), F.silu(moved.view_as(plain))) > 1
        assert kernel_error(*args, plain, F.silu(moved.view_as(plain))) == float("inf")
    if dtype == torch.bfloat16:
        far = (50 + torch.randn((2, 64, 6, 10), generator=torch.Generator().manual_seed(2)))
        far = far.to(dtype)
        args = (far, norm.weight, norm.bias, 32, 1e-6, 1)
        with torch.no_grad():
            plain = gs.gn_silu_reference(*args, dtype, act=False)
        moved = (plain.view(torch.int16) + 4).view(torch.bfloat16)
        assert kernel_error(*args, moved, F.silu(moved)) > 1


# every norm_act / attention-norm input of the three configurations' timed
# paths, (C, H, W, layout's ddof, dtype) with the batches the cells run
CONFIG_SHAPES = {
    # gumbel_vqgan decoding, bf16, 32 images
    "gumbel_decode": (32, torch.bfloat16, 1, [(512, 16, 16), (256, 16, 16), (256, 32, 32),
                                             (256, 64, 64), (128, 64, 64), (128, 128, 128),
                                             (128, 256, 256)]),
    # taming_vqgan_f16 decoding, bf16, 32 images
    "taming_decode": (32, torch.bfloat16, 0, [(512, 16, 16), (256, 32, 32), (512, 32, 32),
                                             (256, 64, 64), (256, 128, 128),
                                             (128, 128, 128), (128, 256, 256)]),
    # ema_vqvae token export, fp32, 256 images
    "ema_encode": (256, torch.float32, 1, [(128, 256, 256), (128, 128, 128), (256, 128, 128),
                                          (256, 64, 64), (256, 32, 32), (512, 32, 32),
                                          (512, 16, 16)]),
}


CONFIGS = {"gumbel_decode": "gumbel_vqgan", "taming_decode": "taming_vqgan_f16",
           "ema_encode": "ema_vqvae"}


@pytest.mark.parametrize("case", sorted(CONFIG_SHAPES))
def test_config_shapes_are_the_models_calls(case, monkeypatch):
    """CONFIG_SHAPES lists each shape the configuration's timed half sends
    to ``gn_silu`` (its modules run on the meta device), and the calls of a
    request: 21, 35 + 4 attention norms, 21."""
    batch, dtype, ddof, shapes = CONFIG_SHAPES[case]
    seen = collections.Counter()

    def record(x, weight, bias, num_groups, eps, ddof_, dtype_, act=True):
        assert (ddof_, dtype_, x.dtype) == (ddof, dtype, dtype)
        seen[(tuple(x.shape[1:]), act)] += 1
        return torch.empty_like(x)

    monkeypatch.setattr(autoencoder, "gn_silu", record)
    model = vqvae.VQVAE.from_config(load_config(str(ROOT / "example_confs"
                                                    / f"{CONFIGS[case]}.yaml")),
                                    dtype=dtype, device="cpu").to("meta")
    with torch.inference_mode():
        if case == "ema_encode":
            model.encoder(torch.empty(batch, 3, 256, 256, device="meta"))
        else:
            d = model.decoder
            first = d.post_quant_conv if hasattr(d, "post_quant_conv") else d.conv_in
            d(torch.empty(batch, first.in_channels, 16, 16, device="meta", dtype=dtype))
    assert sorted({s for s, _ in seen}) == sorted(shapes)
    pairs = sum(v for (_, act), v in seen.items() if act)
    norms = sum(v for (_, act), v in seen.items() if not act)
    assert (pairs, norms) == {"gumbel_decode": (21, 0), "taming_decode": (35, 4),
                              "ema_encode": (21, 0)}[case]


@pytest.mark.parametrize("case", sorted(CONFIG_SHAPES))
def test_plan_takes_the_cluster_form_at_the_configurations_shapes(case):
    batch, dtype, _, shapes = CONFIG_SHAPES[case]
    esize = torch.finfo(dtype).bits // 8
    for c, h, w in shapes:
        n = (c // 32) * h * w
        for b in (1, 2, batch):
            p = gsc.plan(b * 32, n, h * w, esize, True, H100_SMS)
            assert p.parts == 0 and p.vec == 16 // esize, (case, c, h, b, p)
            assert p.slice % p.vec == 0 and p.cluster * p.slice >= n > (p.cluster - 1) * p.slice
            assert p.slice * esize <= gsc.SLICE_BYTES
            assert p.cluster & (p.cluster - 1) == 0 and p.cluster <= gsc.MAX_CLUSTER
    big = gsc.plan(32 * 32, 4 * 65536, 65536, 2, True, H100_SMS)
    assert (big.cluster, big.slice) == (8, 32768)
    export = gsc.plan(256 * 32, 4 * 65536, 65536, 4, True, H100_SMS)
    assert (export.cluster, export.slice) == (16, 16384)


def test_plan_at_large_and_small_groups():
    # the 4096^2 fp32 probe (128 channels): two-pass, chunks of 32 KB, about
    # four statistics CTAs per SM over the grid
    p = gsc.plan(32, 4 * 4096 * 4096, 4096 * 4096, 4, True, H100_SMS)
    assert p == gsc.Plan(4, 0, 8192, 17)
    # just past what 16 CTAs of 64 KB hold: two-pass
    assert gsc.plan(32, 16 * 16384 + 4, 4, 4, True, H100_SMS).parts > 0
    # a small group takes one CTA
    assert gsc.plan(32, 16 * 256, 256, 2, True, H100_SMS) == gsc.Plan(8, 1, 4096, 0)


@pytest.mark.parametrize("n,hw,aligned", [(3 * 7 * 9, 63, True), (4 * 36, 36, True),
                                           (4 * 64, 64, False)])
def test_plan_takes_one_element_an_access_on_ragged_shapes(n, hw, aligned):
    p = gsc.plan(6, n, hw, 2, aligned, H100_SMS)
    assert p.vec == 1 and p.parts == 0 and p.cluster * p.slice >= n


@pytest.mark.parametrize("case", ["gumbel_decode", "taming_decode"])
def test_plan_nhwc_takes_the_grid_form_at_the_decoders_shapes(case):
    """At every bf16 decoder shape the NHWC form is the grid form: rounds of
    whole images over at most one CTA an SM, slices of whole pixels that fit
    ``GRID_SLICE_BYTES``, as few rounds as fit, spread evenly."""
    batch, dtype, _, shapes = CONFIG_SHAPES[case]
    for c, h, w in shapes:
        cg, hw = c // 32, h * w
        for b in (1, 2, batch):
            p = gsc.plan_nhwc(b, 32, cg, hw, 2, True, H100_SMS)
            assert p.images >= 1 and p.parts == 0 and p.vec == 8, (c, h, b, p)
            assert p.images * p.cluster <= H100_SMS and p.images <= b
            assert p.slice == -(-hw // p.cluster) and p.slice * c * 2 <= gsc.GRID_SLICE_BYTES
            rounds = -(-b // p.images)
            fewer = -(-b // (rounds - 1)) if rounds > 1 else None
            assert fewer is None or -(-hw // (H100_SMS // fewer)) * c * 2 > gsc.GRID_SLICE_BYTES
    # 256^2 at 128 channels: one 16 MB image a round over 132 CTAs of 124 KB
    assert gsc.plan_nhwc(32, 32, 4, 65536, 2, True, H100_SMS) == gsc.Plan(8, 132, 497, 0, 0, 1)
    assert gsc.plan_nhwc(32, 32, 4, 16384, 2, True, H100_SMS) == gsc.Plan(8, 26, 631, 0, 0, 5)
    assert gsc.plan_nhwc(32, 32, 16, 256, 2, True, H100_SMS) == gsc.Plan(8, 4, 64, 0, 0, 32)


@pytest.mark.parametrize("cg,esize,aligned,want", [
    (4, 2, True, (4, 8)),      # 128 channels bf16: 4 groups of 8 bytes fill a sector
    (8, 2, True, (2, 8)),
    (16, 2, True, (1, 8)),
    (2, 2, True, (8, 8)),      # a quarter of an access a group
    (1, 2, True, (16, 1)),     # an eighth: one element an access
    (3, 2, True, (8, 1)),      # ragged: 8 groups of 3 channels, 48 bytes
    (4, 2, False, (4, 1)),     # a misaligned pointer: one element an access
    (1024, 2, False, None),    # 1024 accesses a pixel: more than a CTA's threads
])
def test_nhwc_band_fills_sectors(cg, esize, aligned, want):
    assert gsc.nhwc_band(32, cg, esize, aligned) == want


def test_plan_nhwc_at_large_and_ragged_shapes():
    """Where no round of the grid form holds an image, or 16-byte accesses do
    not suit the widths, the two-pass form over sector-wide bands."""
    # (2, 128, 512, 512) bf16: 64 MB an image; bands of 32 bytes, chunks of
    # 32 KB (1024 pixels), about four statistics CTAs per SM
    assert gsc.plan_nhwc(2, 32, 4, 512 * 512, 2, True, H100_SMS) == gsc.Plan(8, 0, 1024, 33, 4)
    # (32, 128, 384, 384) bf16: 36 MB an image
    assert gsc.plan_nhwc(32, 32, 4, 384 * 384, 2, True, H100_SMS) == gsc.Plan(8, 0, 1024, 3, 4)
    # ragged: 96 channels bf16 at 7 x 9, one element an access
    assert gsc.plan_nhwc(2, 32, 3, 63, 2, True, H100_SMS) == gsc.Plan(1, 0, 682, 1, 8)
    # misaligned: one element an access, so the two-pass form
    assert gsc.plan_nhwc(2, 32, 4, 256, 2, False, H100_SMS) == gsc.Plan(1, 0, 1024, 1, 4)


def test_takes_what_the_kernel_reads_as_it_lies():
    x = torch.zeros(2, 128, 8, 8, dtype=torch.bfloat16)
    assert gsc.takes(x, 32)
    assert gsc.takes(x.contiguous(memory_format=torch.channels_last), 32)
    assert not gsc.takes(x.transpose(2, 3), 32)
    # fp32 keeps NCHW: a channels-last fp32 input goes to the kernel on a copy
    assert not gsc.takes(x.float().contiguous(memory_format=torch.channels_last), 32)
    # 32 groups of 1024 channels, misaligned: 1024 accesses a pixel
    wide = torch.zeros(1, 32 * 1024 * 2 + 1, 1, dtype=torch.bfloat16)[:, 1:]
    wide = wide.view(1, 2, 1, 32 * 1024).permute(0, 3, 1, 2)
    assert gs.channels_last(wide) and not gsc.takes(wide, 32)


@pytest.mark.parametrize("name", ["THREADS", "MAX_CLUSTER", "NHWC_THREADS", "MAX_BAND"])
def test_wrapper_constants_match_the_source(name):
    source = (_build.CSRC_DIR / "gn_silu.cu").read_text()
    found = re.search(rf"constexpr int {name} = (\d+);", source)
    assert found and int(found.group(1)) == getattr(gsc, name)


def test_wrapper_args_match_the_source_struct():
    """``Args`` lists ``GnArgs``'s fields in the source's order and types."""
    source = (_build.CSRC_DIR / "gn_silu.cu").read_text()
    body = re.search(r"struct GnArgs \{(.*?)\};", source, re.S).group(1)
    fields = []
    for ctype, names in re.findall(r"^\s*(long long|int|float) ([\w, ]+);", body, re.M):
        fields += [(name.strip(), ctype) for name in names.split(",")]
    kinds = {ctypes.c_longlong: "long long", ctypes.c_int: "int", ctypes.c_float: "float"}
    assert fields == [(name, kinds[t]) for name, t in gsc.Args._fields_]


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, w = torch.zeros(1, 64, 4, 4), torch.ones(1, 64, 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        gsc.gn_silu_cuda(x, w, w, 32, 1e-6, 1, True)
    with pytest.raises(ValueError, match="contiguous"):
        gsc.gn_silu_cuda(x.transpose(2, 3), w, w, 32, 1e-6, 1, True)
    with pytest.raises(ValueError, match="one of"):
        gsc.gn_silu_cuda(x.half(), w, w, 32, 1e-6, 1, True)
    with pytest.raises(ValueError, match="4-D"):
        gsc.gn_silu_cuda(x[0], w, w, 32, 1e-6, 1, True)
    with pytest.raises(ValueError, match="groups"):
        gsc.gn_silu_cuda(x, w, w, 24, 1e-6, 1, True)
    with pytest.raises(ValueError, match="fp32"):
        gsc.gn_silu_cuda(x, w[:, :32], w, 32, 1e-6, 1, True)


# ---------------------------------------------------------------- on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def check_against_plain(x, weight, bias, ddof) -> float:
    """The kernel (GroupNorm, and with the SiLU) against the plain version on
    the card: ``kernel_error`` (<= 1 passes)."""
    norm = gsc.gn_silu_cuda(x, weight, bias, 32, 1e-6, ddof, False)
    act = gsc.gn_silu_cuda(x, weight, bias, 32, 1e-6, ddof, True)
    return kernel_error(x, weight, bias, 32, 1e-6, ddof, norm, act)


def _case(shape, dtype, dev, seed, mean=1.5, std=2.0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = shape[1]
    x = (mean + std * torch.randn(shape, device=dev, generator=gen)).to(dtype)
    weight = (1 + 0.5 * torch.randn(1, c, 1, 1, device=dev, generator=gen))
    bias = 0.5 * torch.randn(1, c, 1, 1, device=dev, generator=gen)
    return x, weight, bias


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CONFIG_SHAPES))
def test_kernel_matches_plain_version_on_card(case):
    dev = _card()
    batch, dtype, ddof, shapes = CONFIG_SHAPES[case]
    for k, (c, h, w) in enumerate(shapes):
        # the cells' batch at 256^2; at batch 2 also inputs far from 0
        runs = [(2, 1.5, 2.0), (2, 50.0, 1.0), (2, -50.0, 1.0)]
        for b, mean, std in runs + [(batch, 1.5, 2.0)] if h == 256 else runs:
            x, weight, bias = _case((b, c, h, w), dtype, dev, k, mean, std)
            worst = check_against_plain(x, weight, bias, ddof)
            assert worst <= 1, (case, b, c, h, mean, worst)
            again = gsc.gn_silu_cuda(x, weight, bias, 32, 1e-6, ddof, True)
            assert torch.equal(again, gsc.gn_silu_cuda(x, weight, bias, 32, 1e-6, ddof, True))
            del x, again
            torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gumbel_decode", "taming_decode"])
def test_nhwc_form_matches_plain_version_on_card(case):
    """Channels-last inputs at every bf16 decoder shape, at batch 2 (also
    with means 50 times the spread) and at the cells' batch of 32 at 256^2:
    the NHWC form within ``kernel_error``'s limit, its output channels-last,
    two launches bit-identical, one launch and one NHWC call a call."""
    dev = _card()
    batch, dtype, ddof, shapes = CONFIG_SHAPES[case]
    for k, (c, h, w) in enumerate(shapes):
        runs = [(2, 1.5, 2.0), (2, 50.0, 1.0), (2, -50.0, 1.0)]
        for b, mean, std in runs + [(batch, 1.5, 2.0)] if h == 256 else runs:
            x, weight, bias = _case((b, c, h, w), dtype, dev, k, mean, std)
            x = x.contiguous(memory_format=torch.channels_last)
            launches, calls = gs.gn_silu.launches, gs.gn_silu.nhwc_calls
            worst = check_against_plain(x, weight, bias, ddof)
            assert worst <= 1, (case, b, c, h, mean, worst)
            assert (gs.gn_silu.launches - launches, gs.gn_silu.nhwc_calls - calls) == (2, 2)
            again = gsc.gn_silu_cuda(x, weight, bias, 32, 1e-6, ddof, True)
            assert gs.channels_last(again)
            assert torch.equal(again, gsc.gn_silu_cuda(x, weight, bias, 32, 1e-6, ddof, True))
            del x, again
            torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((2, 64, 7, 9), torch.bfloat16),
                                         ((2, 96, 7, 9), torch.bfloat16),
                                         ((3, 96, 5, 5), torch.bfloat16),
                                         ((2, 32, 6, 10), torch.bfloat16),
                                         ((2, 64, 12, 12), torch.bfloat16)])
def test_nhwc_form_on_ragged_and_misaligned_inputs_on_card(shape, dtype):
    """Channel counts whose groups do not suit 16-byte accesses take the
    two-pass form one element an access; a channels-last view one element
    off 16-byte alignment too; both within the limit."""
    dev = _card()
    x, weight, bias = _case(shape, dtype, dev, 5)
    x = x.contiguous(memory_format=torch.channels_last)
    for ddof in (0, 1):
        assert check_against_plain(x, weight, bias, ddof) <= 1
    b, c, h, w = shape
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
    shifted = flat[1:].view(b, h, w, c).permute(0, 3, 1, 2)
    shifted.copy_(x)
    assert gs.channels_last(shifted) and shifted.data_ptr() % 16
    calls = gs.gn_silu.nhwc_calls
    assert check_against_plain(shifted, weight, bias, 1) <= 1
    assert gs.gn_silu.nhwc_calls - calls == 2


@pytest.mark.cuda
def test_nhwc_two_pass_form_on_card():
    """(2, 128, 512, 512) bf16 channels-last: 64 MB an image, more than a
    round of the grid form holds: the two-pass form, two launches a call."""
    dev = _card()
    x, weight, bias = _case((2, 128, 512, 512), torch.bfloat16, dev, 9)
    x = x.contiguous(memory_format=torch.channels_last)
    assert gsc.plan_nhwc(2, 32, 4, 512 * 512, 2, True, H100_SMS).parts > 0
    launches, calls = gs.gn_silu.launches, gs.gn_silu.nhwc_calls
    assert check_against_plain(x, weight, bias, 1) <= 1
    assert (gs.gn_silu.launches - launches, gs.gn_silu.nhwc_calls - calls) == (4, 2)
    again = gsc.gn_silu_cuda(x, weight, bias, 32, 1e-6, 1, True)
    assert torch.equal(again, gsc.gn_silu_cuda(x, weight, bias, 32, 1e-6, 1, True))


@pytest.mark.cuda
def test_silu_gives_f_silu_bits_at_every_bf16_value_on_card():
    """With w = 0 the GroupNorm's output is the bias: 65536 channels whose
    biases are the 65536 bf16 bit patterns put every bf16 value through the
    kernel's SiLU, which must give ``F.silu``'s bits (NaN for NaN)."""
    dev = _card()
    values = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).to(dev)
    x = torch.randn(1, 65536, 1, 8, device=dev).bfloat16()
    zero = torch.zeros(65536, device=dev)
    norm = gsc.gn_silu_cuda(x, zero, values.float(), 32, 1e-6, 0, False)[0, :, 0, 0]
    act = gsc.gn_silu_cuda(x, zero, values.float(), 32, 1e-6, 0, True)[0, :, 0, 0]
    assert bool(((norm == values) | (norm.isnan() & values.isnan())).all())
    want = F.silu(norm)
    same = (act.view(torch.int16) == want.view(torch.int16)) | (act.isnan() & want.isnan())
    assert bool(same.all()), values[~same][:8].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((2, 64, 7, 9), torch.bfloat16),
                                         ((3, 96, 5, 5), torch.float32),
                                         ((1, 32, 1, 1), torch.float32),
                                         ((2, 64, 12, 12), torch.bfloat16)])
def test_kernel_on_ragged_and_misaligned_inputs_on_card(shape, dtype):
    dev = _card()
    x, weight, bias = _case(shape, dtype, dev, 5)
    for ddof in (0, 1):
        assert check_against_plain(x, weight, bias, ddof) <= 1
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
    shifted = flat[1:].view(shape)
    shifted.copy_(x)
    assert torch.equal(gsc.gn_silu_cuda(shifted, weight, bias, 32, 1e-6, 1, True),
                       gsc.gn_silu_cuda(x, weight, bias, 32, 1e-6, 1, True))


@pytest.mark.cuda
def test_two_pass_form_and_more_than_2_31_elements_on_card():
    """A (1, 128, 2048, 2048) fp32 image has groups of 2^24 elements (64 MB,
    no cluster holds them: the two-pass form), and (66, 128, 512, 512) bf16
    has 2^31 + 2^26 elements: its last groups sit past 32-bit offsets."""
    dev = _card()
    x, weight, bias = _case((1, 128, 2048, 2048), torch.float32, dev, 7)
    assert gsc.plan(32, 4 * 2048 * 2048, 2048 * 2048, 4, True, H100_SMS).parts > 0
    launches = gs.gn_silu.launches
    assert check_against_plain(x, weight, bias, 1) <= 1
    assert gs.gn_silu.launches - launches == 2 * 2   # two calls of two kernels
    del x
    torch.cuda.empty_cache()
    x, weight, bias = _case((66, 128, 512, 512), torch.bfloat16, dev, 8)
    assert x.numel() > 2 ** 31
    norm = gsc.gn_silu_cuda(x, weight, bias, 32, 1e-6, 0, False)
    act = gsc.gn_silu_cuda(x, weight, bias, 32, 1e-6, 0, True)
    for i in (0, 64, 65):
        assert kernel_error(x[i:i + 1], weight, bias, 32, 1e-6, 0, norm[i:i + 1],
                            act[i:i + 1]) <= 1, i


@pytest.mark.cuda
def test_non_contiguous_input_takes_the_kernel_on_card():
    """A channels_last input takes the NHWC form as it lies (one launch, one
    NHWC call, a channels-last output within the limit); a transposed one
    goes to the kernel on a contiguous copy (one launch, the bits of the
    contiguous input's call); an input in another dtype than the module's
    raises."""
    dev = _card()
    norm = _norm(128, torch.bfloat16, 0).to(dev)
    x = _input((2, 128, 16, 24), torch.bfloat16).to(dev)
    with torch.no_grad():
        want = norm_act(norm, x)
        nhwc = x.contiguous(memory_format=torch.channels_last)
        launches, calls = gs.gn_silu.launches, gs.gn_silu.nhwc_calls
        got = norm_act(norm, nhwc)
        assert (gs.gn_silu.launches - launches, gs.gn_silu.nhwc_calls - calls) == (1, 1)
        assert gs.channels_last(got)
        alone = gsc.gn_silu_cuda(nhwc, norm.weight, norm.bias, 32, 1e-6, 0, False)
        assert kernel_error(nhwc, norm.weight, norm.bias, 32, 1e-6, 0, alone, got) <= 1
        other = x.transpose(2, 3).contiguous().transpose(2, 3)
        assert not other.is_contiguous() and not gs.channels_last(other)
        launches, calls = gs.gn_silu.launches, gs.gn_silu.nhwc_calls
        got = norm_act(norm, other)
        assert (gs.gn_silu.launches - launches, gs.gn_silu.nhwc_calls - calls) == (1, 0)
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match="dtype"):
            norm_act(norm, x.float())


def _count_call(fn) -> tuple:
    """(launches, NHWC calls, norm_act spans) of one call of ``fn`` under a
    capture."""
    launches, calls = gs.gn_silu.launches, gs.gn_silu.nhwc_calls
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()
    torch.cuda.synchronize()
    spans = sum(s["name"] == "norm_act" for s in introspect.span_log())
    return gs.gn_silu.launches - launches, gs.gn_silu.nhwc_calls - calls, spans


@pytest.mark.cuda
def test_launches_per_call_on_card():
    dev = _card()
    gen = torch.Generator().manual_seed(0)
    taming = vqvae.VQVAE.from_config(load_config(str(ROOT / "example_confs"
                                                     / "taming_vqgan_f16.yaml")),
                                     dtype=torch.bfloat16, device=dev, generator=gen)
    tokens = torch.randint(0, 16384, (2, 256), device=dev)
    assert _count_call(lambda: taming.reconstruct_from_tokens(tokens)) == (35 + 4, 35 + 4, 35)
    del taming
    gumbel = vqvae.VQVAE.from_config(load_config(str(ROOT / "example_confs"
                                                     / "gumbel_vqgan.yaml")),
                                     dtype=torch.bfloat16, device=dev, generator=gen)
    tokens = torch.randint(0, 1024, (2, 256), device=dev)
    assert _count_call(lambda: gumbel.reconstruct_from_tokens(tokens)) == (21, 21, 21)
    del gumbel
    ema = vqvae.VQVAE.from_config(load_config(str(ROOT / "example_confs" / "ema_vqvae.yaml")),
                                  device=dev, generator=gen)
    images = torch.rand(2, 256, 256, 3, device=dev)
    assert _count_call(lambda: ema.get_tokens(images)) == (21, 0, 21)


@pytest.mark.cuda
def test_a_training_step_launches_nothing_on_card(monkeypatch, tmp_path):
    dev = _card()
    monkeypatch.setenv("VQVAE_TPU_LPIPS_WEIGHTS_DIR", str(tmp_path / "lpips"))
    with pytest.warns(UserWarning, match="LPIPS"):
        trainer = Trainer(tiny_cfg(), learning_rate=1e-4, seed=0, steps_per_epoch=1000,
                          device=dev, disc_kwargs={"channel_base": 256})
    state = trainer.init_state()
    images = torch.randint(0, 256, (4, 16, 16, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    launches, calls = gs.gn_silu.launches, gs.gn_silu.nhwc_calls
    for host_step in (0, 1):
        trainer.host_step = host_step
        trainer.train_step(state, {"image": images}, epoch=0)
    torch.cuda.synchronize()
    assert gs.gn_silu.launches == launches
    trainer.eval_step(state, {"image": images}, epoch=0)
    assert gs.gn_silu.launches == launches + 2 * (2 * 3 + 1)
    assert gs.gn_silu.nhwc_calls == calls   # fp32: contiguous NCHW
