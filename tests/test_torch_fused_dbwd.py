"""Kernels B3 and B4 of the PyTorch port against the JAX package on the CPU.

- The plain versions (``blur_t_gate_reference``, ``skip_fanout_bwd_reference``)
  against the XLA oracles ``_blur_t_gate_xla`` / ``_skip_fanout_bwd_xla`` and
  against the Pallas kernels in interpret mode, at the JAX tests' shapes
  (NHWC there, NCHW here): fp32 rtol/atol 1e-5 (the 16-tap sums are taken
  in other orders), db0 rtol 1e-5 of the channel's term scale; bf16 within
  2e-2 as the JAX test holds its kernel to its oracle.
- ``FusedActBlur`` / ``FusedSkipFanout``: forward identical to the plain
  span, gradients equal to autograd of it (rtol 1e-5), no double backward.
- The kernel wrappers reject what the kernels do not take, and CUDA tensors
  reach the kernels contiguous; the card tests (``cuda``) hold the kernels
  to the plain versions and skip here.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.ops.fused_dbwd import (_blur_t_gate_xla, _skip_fanout_bwd_xla,
                                      blur_t_gate_pallas, skip_fanout_bwd_pallas)
from vqvae_tpu_torch.ops import _build
from vqvae_tpu_torch.ops import fused_dbwd as fd
from vqvae_tpu_torch.ops import fused_dbwd_cuda as fdc
from vqvae_tpu_torch.ops.fused_dbwd_cuda import blur_t_gate_cuda, skip_fanout_bwd_cuda
from vqvae_tpu_torch.ops.upfirdn2d import upfirdn2d

torch.set_num_threads(1)

TAPS = fd.TAPS
ALPHA, GAIN = 0.2, float(np.sqrt(2.0))
SHAPES = [((2, 16, 16, 128), np.float32), ((1, 64, 24, 256), np.float32),
          ((2, 32, 16, 128), "bfloat16")]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _b3_inputs(shape, dtype, seed=0):
    b, h, w, c = shape
    rs = np.random.RandomState(seed)
    dy = rs.randn(b, h + 1, w + 1, c).astype(np.float32)
    p0 = rs.randn(b, h, w, c).astype(np.float32)
    b0 = rs.randn(c).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jax_in = (jnp.asarray(dy, jdt), jnp.asarray(p0, jdt), jnp.asarray(b0))
    port_in = (_nchw(np.asarray(jax_in[0], np.float32)).to(tdt),
               _nchw(np.asarray(jax_in[1], np.float32)).to(tdt), torch.from_numpy(b0))
    return jax_in, port_in


@pytest.mark.parametrize("shape,dtype", SHAPES, ids=["f32", "f32-odd", "bf16"])
@pytest.mark.parametrize("other", ["xla", "pallas"])
def test_blur_t_gate_reference_matches_jax(shape, dtype, other):
    jax_in, port_in = _b3_inputs(shape, dtype)
    fn = _blur_t_gate_xla if other == "xla" else (
        lambda *a: blur_t_gate_pallas(*a, interpret=True))
    want_dp, want_db = (np.asarray(v, np.float32) for v in fn(*jax_in, TAPS, ALPHA, GAIN))
    dp, db = fd.blur_t_gate_reference(*port_in, TAPS, ALPHA, GAIN)
    assert dp.dtype == port_in[1].dtype and db.dtype == torch.float32
    tol = 1e-5 if dtype == np.float32 else 2e-2
    np.testing.assert_allclose(_nhwc(dp), want_dp, rtol=tol, atol=tol)
    scale = np.abs(want_dp).sum((0, 1, 2))
    if dtype == np.float32:
        np.testing.assert_allclose(db.numpy(), want_db, rtol=1e-5, atol=1e-5 * scale.max())
    else:
        # both sum bf16-rounded blur outputs in fp32 (the Pallas kernel's are
        # unrounded): hold to the term scale, as the JAX test does
        np.testing.assert_allclose(db.numpy(), want_db, rtol=2e-2,
                                   atol=2e-3 * scale.max() ** 0.5 + 1e-3)


@pytest.mark.parametrize("shape,dtype", SHAPES, ids=["f32", "f32-odd", "bf16"])
@pytest.mark.parametrize("other", ["xla", "pallas"])
def test_skip_fanout_bwd_reference_matches_jax(shape, dtype, other):
    b, h, w, c = shape
    rs = np.random.RandomState(5)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    dc = jnp.asarray(rs.randn(b, h, w, c), jdt)
    dys = jnp.asarray(rs.randn(b, h // 2, w // 2, c), jdt)
    fn = _skip_fanout_bwd_xla if other == "xla" else (
        lambda *a: skip_fanout_bwd_pallas(*a, interpret=True))
    want = np.asarray(fn(dc, dys, TAPS), np.float32)
    got = fd.skip_fanout_bwd_reference(_nchw(dc).to(tdt), _nchw(dys).to(tdt), TAPS)
    assert got.dtype == tdt
    tol = 1e-5 if dtype == np.float32 else 2e-2
    np.testing.assert_allclose(_nhwc(got), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("h,w", [(7, 9), (8, 5), (3, 2)])
def test_skip_fanout_bwd_reference_is_the_adjoint_at_odd_sides(h, w):
    """<skip_fir(x), dys> == <x, skip_fanout_bwd(0, dys)> in float64, for
    sides the discriminator never has (the kernel takes any H and W)."""
    gen = torch.Generator().manual_seed(h * 10 + w)
    x = torch.randn(2, 3, h, w, dtype=torch.float64, generator=gen)
    _, ys = fd.skip_fanout(x)
    dys = torch.randn(ys.shape, dtype=torch.float64, generator=gen)
    assert ys.shape[2:] == (h // 2, w // 2)
    back = fd.skip_fanout_bwd_reference(torch.zeros_like(x), dys)
    torch.testing.assert_close((ys * dys).sum(), (x * back).sum(), rtol=1e-12, atol=1e-12)


def _act_blur_inputs(seed, shape=(2, 5, 9, 7)):
    gen = torch.Generator().manual_seed(seed)
    p0 = torch.randn(shape, generator=gen, requires_grad=True)
    b0 = torch.randn(shape[1], generator=gen, requires_grad=True)
    return p0, b0


def test_fused_act_blur_matches_autograd():
    p0, b0 = _act_blur_inputs(0)
    y = fd.FusedActBlur.apply(p0, b0, TAPS, ALPHA, GAIN)
    want = fd.act_blur(p0, b0, TAPS, ALPHA, GAIN)
    assert torch.equal(y, want) and y.shape == (2, 5, 10, 8)
    ct = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad(y, (p0, b0), ct)
    ref = torch.autograd.grad(want, (p0, b0), ct)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


def test_fused_skip_fanout_matches_autograd():
    x = torch.randn(2, 5, 9, 8, generator=torch.Generator().manual_seed(2), requires_grad=True)
    a, ys = fd.FusedSkipFanout.apply(x, TAPS)
    a_ref, ys_ref = fd.skip_fanout(x, TAPS)
    assert torch.equal(a, x) and torch.equal(ys, ys_ref)
    gen = torch.Generator().manual_seed(3)
    ca, cs = torch.randn(a.shape, generator=gen), torch.randn(ys.shape, generator=gen)
    (got,) = torch.autograd.grad((a, ys), x, (ca, cs))
    (want,) = torch.autograd.grad((a_ref, ys_ref), x, (ca, cs))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("which", ["act_blur", "skip_fanout"])
def test_double_backward_raises(which):
    if which == "act_blur":
        p0, b0 = _act_blur_inputs(4)
        x = p0
        out = fd.FusedActBlur.apply(p0, b0, TAPS, ALPHA, GAIN)
    else:
        x = torch.randn(1, 2, 8, 8, requires_grad=True)
        out = fd.FusedSkipFanout.apply(x, TAPS)[1]
    (g,) = torch.autograd.grad(out.square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|twice"):
        g.sum().backward()


def test_cpu_tensors_take_the_plain_versions():
    before = (fd.blur_t_gate.launches, fd.skip_fanout_bwd.launches)
    p0, b0 = _act_blur_inputs(5)
    dy = torch.randn(2, 5, 10, 8)
    dp, db = fd.blur_t_gate(dy, p0.detach(), b0.detach())
    want = fd.blur_t_gate_reference(dy, p0.detach(), b0.detach())
    assert torch.equal(dp, want[0]) and torch.equal(db, want[1])
    dc, dys = torch.randn(2, 5, 8, 6), torch.randn(2, 5, 4, 3)
    assert torch.equal(fd.skip_fanout_bwd(dc, dys), fd.skip_fanout_bwd_reference(dc, dys))
    assert (fd.blur_t_gate.launches, fd.skip_fanout_bwd.launches) == before


def test_functions_hand_the_kernels_contiguous_tensors(monkeypatch):
    """The Functions make every cotangent contiguous before dispatch: the
    kernel wrappers take NCHW-contiguous tensors only."""
    from vqvae_tpu_torch.ops import fused_dbwd_cuda
    seen = []

    def fake_b3(dy, p0, b0, taps, alpha, gain):
        seen.append(all(t.is_contiguous() for t in (dy, p0, b0)))
        return fd.blur_t_gate_reference(dy, p0, b0, taps, alpha, gain)

    def fake_b4(dc, dys, taps):
        seen.append(dc.is_contiguous() and dys.is_contiguous())
        return fd.skip_fanout_bwd_reference(dc, dys, taps)

    monkeypatch.setattr(fused_dbwd_cuda, "blur_t_gate_cuda", fake_b3)
    monkeypatch.setattr(fused_dbwd_cuda, "skip_fanout_bwd_cuda", fake_b4)
    monkeypatch.setattr(fd, "_on_cpu", lambda *t: False)   # as if on the card
    p0, b0 = _act_blur_inputs(6)
    y = fd.FusedActBlur.apply(p0, b0, TAPS, ALPHA, GAIN)
    # a channels-last cotangent: not contiguous in NCHW
    ct = torch.randn(y.shape).contiguous(memory_format=torch.channels_last)
    assert not ct.is_contiguous()
    y.backward(ct)
    x = torch.randn(2, 4, 8, 8, requires_grad=True)
    a, ys = fd.FusedSkipFanout.apply(x, TAPS)
    (a.sum() + (ys * torch.randn(ys.shape).transpose(2, 3).contiguous().transpose(2, 3)).sum()
     ).backward()
    assert seen == [True, True]


def test_wrappers_reject_what_the_kernels_do_not_take():
    dy, p0, b0 = torch.zeros(1, 2, 5, 5), torch.zeros(1, 2, 4, 4), torch.zeros(2)
    with pytest.raises(ValueError, match="CUDA"):
        blur_t_gate_cuda(dy, p0, b0, TAPS, ALPHA, GAIN)
    with pytest.raises(ValueError, match="CUDA"):
        skip_fanout_bwd_cuda(p0, torch.zeros(1, 2, 2, 2), TAPS)
    with pytest.raises(ValueError, match="contiguous"):
        blur_t_gate_cuda(dy.transpose(2, 3), p0, b0, TAPS, ALPHA, GAIN)
    with pytest.raises(ValueError, match="contiguous"):
        skip_fanout_bwd_cuda(p0.transpose(2, 3), torch.zeros(1, 2, 2, 2), TAPS)
    with pytest.raises(ValueError, match="one of"):
        blur_t_gate_cuda(dy.half(), p0.half(), b0, TAPS, ALPHA, GAIN)
    with pytest.raises(ValueError, match="4-D"):
        skip_fanout_bwd_cuda(p0[0], torch.zeros(1, 2, 2, 2), TAPS)


# the 256^2 D's blocks at batch 32: (C, H = W)
D_BLOCKS = [(128, 256), (256, 128), (512, 64), (512, 32), (512, 16), (512, 8)]
H100_SMS = 132


@pytest.mark.parametrize("name", ["THREADS", "VEC"])
def test_wrapper_constants_match_the_source(name):
    source = (_build.CSRC_DIR / "fused_dbwd.cu").read_text()
    found = re.search(rf"constexpr int {name} = (\d+);", source)
    assert found and int(found.group(1)) == getattr(fdc, name)


@pytest.mark.parametrize("which", ["b3", "b4"])
@pytest.mark.parametrize("c,h", D_BLOCKS)
def test_geometry_gives_every_lane_work_at_the_d_blocks(which, c, h):
    """At every D block shape the vector path's workers fill their lanes
    (8^2, 16^2 and 32^2 planes pack several planes into a warp), the grid
    has no idle tail, and it holds MIN_WAVES blocks per SM unless the strip
    is already one row."""
    geo_fn = fdc.blur_t_gate_geometry if which == "b3" else fdc.skip_fanout_bwd_geometry
    rows = h if which == "b3" else -(-h // 2)
    geo = geo_fn(32, c, h, h, True, H100_SMS)
    lanes = h // fdc.VEC
    assert geo.seg_width * geo.segments == lanes
    assert geo.blocks * (fdc.THREADS // geo.seg_width) == 32 * c * geo.segments * geo.strips
    assert geo.strips == -(-rows // geo.strip) and 1 <= geo.strip <= fdc.MAX_STRIP
    assert geo.blocks >= fdc.MIN_WAVES * H100_SMS or geo.strip == 1


@pytest.mark.parametrize("w", [1, 3, 7, 9, 17, 31, 33, 65, 100, 255, 520, 1000])
def test_geometry_on_ragged_rows(w):
    """Scalar rows (and a wide vector row): segments are powers of two up to
    32 lanes, more than half of a row's segment lanes have outputs, and the
    strips cover the plane."""
    for vec in (False, True) if w % fdc.VEC == 0 else (False,):
        for lanes_fn, rows in ((fdc.blur_t_gate_geometry, 37), (fdc.skip_fanout_bwd_geometry, 19)):
            geo = lanes_fn(3, 5, 37, w, vec, H100_SMS)
            lanes = (w // fdc.VEC if vec else w if lanes_fn is fdc.blur_t_gate_geometry
                     else -(-w // 2))
            sw = geo.seg_width
            assert sw & (sw - 1) == 0 and sw <= 32
            assert geo.segments == -(-lanes // sw) and lanes > (geo.segments * sw) // 2
            assert geo.strips * geo.strip >= rows > (geo.strips - 1) * geo.strip


def test_vector_path_rule():
    assert fdc.vector_path(256, True, True)
    assert not fdc.vector_path(252, True, True)
    assert not fdc.vector_path(256, True, False)
    assert fdc.vector_path(8)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# B3 / B4 card shapes (B, C, H, W): narrow planes packed several to a warp
# (8^2, 16^2, 32^2), a plane count that is no multiple of the planes a block
# holds, ragged W (the scalar path), a tall plane over several strips, rows
# wider than one segment (W 520: three segments, the last with one lane)
CARD_SHAPES = [(2, 64, 8, 8), (3, 50, 16, 16), (2, 128, 32, 32), (1, 37, 7, 9),
               (3, 130, 33, 65), (8, 64, 256, 256), (2, 8, 300, 520), (1, 5, 33, 40)]
# inputs 1 element past an aligned buffer: P0 / dC so take the scalar path;
# dY and dYs are read unaligned on the vector path too
MISALIGNED = {"b3": ("dy", "p0"), "b4": ("dc", "dys")}


def _card_randn(shape, dtype, gen, offset=False):
    n = int(np.prod(shape))
    t = torch.randn(n + int(offset), device=gen.device, generator=gen).to(dtype)
    return t[int(offset):].view(shape)


def _b3_case(shape, dtype, gen, offset=None):
    b, c, h, w = shape
    dy = _card_randn((b, c, h + 1, w + 1), dtype, gen, offset == "dy")
    p0 = _card_randn((b, c, h, w), dtype, gen, offset == "p0")
    return dy, p0, torch.randn(c, device=gen.device, generator=gen)


@pytest.mark.cuda
def test_blur_t_gate_kernel_matches_plain_version_on_card():
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = ([(shape, None) for shape in CARD_SHAPES]
             + [((2, 16, 24, 64), o) for o in MISALIGNED["b3"]])
    for shape, offset in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dy, p0, b0 = _b3_case(shape, dtype, gen, offset)
            before = fd.blur_t_gate.launches
            dp, db = blur_t_gate_cuda(dy, p0, b0, TAPS, ALPHA, GAIN)
            assert fd.blur_t_gate.launches == before + 1
            # the plain version on fp32 dy: the kernel's blur is unrounded
            want_dp, _ = fd.blur_t_gate_reference(dy.float(), p0, b0, TAPS, ALPHA, GAIN)
            tol = 1e-5 if dtype == torch.float32 else 1e-2
            torch.testing.assert_close(dp.float(), want_dp.float(), rtol=tol, atol=tol,
                                       msg=lambda m: f"{shape} {dtype} {offset}: {m}")
            # db0 against a float64 sum with the kernel's gate: p0 + b0 in p0's dtype
            s = p0 + b0.to(dtype)[None, :, None, None]
            exact = (upfirdn2d(dy.double(), fd._f2d(TAPS), padding=1, flip_filter=True)
                     * torch.where(s >= 0, GAIN, GAIN * ALPHA).double())
            scale = exact.abs().sum((0, 2, 3))
            assert bool(((db.double() - exact.sum((0, 2, 3))).abs() <= 1e-5 * scale).all()), \
                (shape, dtype, offset)
            again = blur_t_gate_cuda(dy, p0, b0, TAPS, ALPHA, GAIN)
            assert torch.equal(dp, again[0]) and torch.equal(db, again[1]), (shape, dtype, offset)


@pytest.mark.cuda
def test_skip_fanout_bwd_kernel_matches_plain_version_on_card():
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = ([(shape, None) for shape in CARD_SHAPES + [(1, 3, 7, 9), (2, 130, 16, 8)]]
             + [((2, 16, 24, 64), o) for o in MISALIGNED["b4"]])
    for (b, c, h, w), offset in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dc = _card_randn((b, c, h, w), dtype, gen, offset == "dc")
            dys = _card_randn((b, c, h // 2, w // 2), dtype, gen, offset == "dys")
            before = fd.skip_fanout_bwd.launches
            got = skip_fanout_bwd_cuda(dc, dys, TAPS)
            assert fd.skip_fanout_bwd.launches == before + 1
            want = fd.skip_fanout_bwd_reference(dc.float(), dys.float(), TAPS)
            tol = 1e-5 if dtype == torch.float32 else 1e-2
            torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol,
                                       msg=lambda m: f"{(b, c, h, w)} {dtype} {offset}: {m}")
            assert torch.equal(got, skip_fanout_bwd_cuda(dc, dys, TAPS)), (b, c, h, w, dtype)
