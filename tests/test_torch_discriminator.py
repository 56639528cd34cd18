"""The discriminator stack of the PyTorch port against the JAX package on the
CPU, fp32: ``bias_act``, ``upfirdn2d`` and ``conv2d_resample`` (rtol 1e-5 /
atol 1e-6), ``minibatch_std`` (rtol 1e-6), and the whole ``Discriminator``
at 16^2 and 32^2 with a small ``channel_base`` and the JAX weights carried
across: logits (rtol 1e-5 / atol 1e-5), parameter and image gradients
(rtol 1e-4 / atol 1e-6 of each tensor's scale), the fused module against
the plain one (identical logits, gradients rtol 1e-5), and the R1 penalty
and its second-order parameter gradient against ``jax.grad`` of the JAX
package's ``r1_penalty`` (rtol 1e-4). The weights map both ways: the port's
state dict read by ``vqvae_tpu/utils/torch_convert.py`` gives the flax
params back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.losses.losses import r1_penalty
from vqvae_tpu.models import discriminator as jd
from vqvae_tpu.ops import bias_act as jba
from vqvae_tpu.ops import conv2d_resample as jcr
from vqvae_tpu.ops import upfirdn2d as jup
from vqvae_tpu.utils.torch_convert import convert_discriminator_state_dict
from vqvae_tpu_torch.models import discriminator as td
from vqvae_tpu_torch.ops import bias_act as tba
from vqvae_tpu_torch.ops import conv2d_resample as tcr
from vqvae_tpu_torch.ops import upfirdn2d as tup
from vqvae_tpu_torch.utils.convert import convert_discriminator_params

torch.set_num_threads(1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("act", ["linear", "relu", "lrelu", "tanh", "sigmoid", "elu", "selu",
                                 "softplus", "swish"])
def test_bias_act_matches_jax(act):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 4, 5, 3).astype(np.float32)
    b = rs.randn(3).astype(np.float32)
    want = np.asarray(jba.bias_act(jnp.asarray(x), jnp.asarray(b), act=act, gain=1.3, clamp=1.5))
    got = tba.bias_act(_nchw(x), torch.from_numpy(b), act=act, gain=1.3, clamp=1.5)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-6)
    # (B, C) features: the bias over dim 1
    want2 = np.asarray(jba.bias_act(jnp.asarray(x[:, 0, 0]), jnp.asarray(b), act=act))
    got2 = tba.bias_act(torch.from_numpy(x[:, 0, 0]), torch.from_numpy(b), act=act)
    np.testing.assert_allclose(got2.numpy(), want2, rtol=1e-5, atol=1e-6)


def test_lrelu_slope_at_zero_is_one():
    x = torch.zeros(3, requires_grad=True)
    tba.bias_act(x, act="lrelu", gain=1.0).sum().backward()
    assert torch.equal(x.grad, torch.ones(3))


@pytest.mark.parametrize("kw", [
    dict(up=2, padding=(2, 1, 2, 1)),
    dict(down=2, padding=1),
    dict(padding=2),
    dict(padding=(1, -1, 2, 0)),                 # negative pad = crop
    dict(up=2, down=2, padding=(1, 2, 0, 1), flip_filter=True),
    dict(up=(2, 1), padding=(0, 1, 1, 0), gain=3.0),
    dict(down=(1, 2), padding=(1, 1, 0, 2), flip_filter=True),
])
@pytest.mark.parametrize("separable", [False, True])
def test_upfirdn2d_matches_jax(kw, separable):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 9, 7, 3).astype(np.float32)
    f = jup.setup_filter([1, 2, 4, 1] if not separable else [1, 3, 3, 1], separable=separable)
    assert np.array_equal(f, tup.setup_filter([1, 2, 4, 1] if not separable else [1, 3, 3, 1],
                                              separable=separable))
    want = np.asarray(jup.upfirdn2d(jnp.asarray(x), f, **kw))
    got = tup.upfirdn2d(_nchw(x), f, **kw)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k,up,down,padding,flip_weight", [
    (3, 1, 2, 1, True),    # conv1 of a D block
    (1, 1, 2, 0, True),    # the skip path
    (3, 1, 1, 1, True),    # conv0
    (1, 2, 1, 0, False),   # pointwise + up
    (3, 2, 1, 1, False),   # generic branch
    (3, 1, 1, 2, False),
])
def test_conv2d_resample_matches_jax(k, up, down, padding, flip_weight):
    rs = np.random.RandomState(2)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    w = rs.randn(k, k, 4, 5).astype(np.float32)  # HWIO
    f = jup.setup_filter([1, 3, 3, 1])
    want = np.asarray(jcr.conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=f, up=up, down=down,
                                          padding=padding, flip_weight=flip_weight))
    got = tcr.conv2d_resample(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), f=f,
                              up=up, down=down, padding=padding, flip_weight=flip_weight)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,f", [(8, 1), (4, 2), (2, 1), (12, 1)])
def test_minibatch_std_matches_jax(n, f):
    x = np.random.RandomState(n).randn(n, 4, 4, 6).astype(np.float32)
    want = np.asarray(jd.minibatch_std(jnp.asarray(x), 4, f))
    got = td.minibatch_std(_nchw(x), 4, f)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-6, atol=1e-6)


def _jax_disc(res, channel_base, seed):
    """Flax D and numpy params: the init's unit-normal weights, biases drawn
    (the init's are 0, which would hide the bias paths)."""
    module = jd.Discriminator(img_resolution=res, channel_base=channel_base)
    params = module.init(jax.random.PRNGKey(seed), jnp.zeros((4, res, res, 3)))["params"]
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: (0.1 * rs.randn(*p.shape) if path[-1].key == "bias"
                         else np.asarray(p)).astype(np.float32), jax.device_get(params))
    return module, params


def _port_disc(res, channel_base, params, **kw):
    disc = td.Discriminator(res, channel_base=channel_base, device="cpu", **kw)
    disc.load_state_dict(convert_discriminator_params(params), strict=True)
    return disc


CASES = [(16, 256), (32, 512)]


@pytest.mark.parametrize("res,channel_base", CASES)
def test_discriminator_matches_jax(res, channel_base):
    module, params = _jax_disc(res, channel_base, seed=res)
    disc = _port_disc(res, channel_base, params)
    x = np.random.RandomState(7).uniform(-1, 1, (8, res, res, 3)).astype(np.float32)

    def jloss(p, im):
        return jnp.sum(module.apply({"params": p}, im) * jnp.arange(1.0, 9.0)[:, None])

    want_logits = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    want_gp, want_gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    img = _nchw(x).requires_grad_(True)
    logits = disc(img)
    assert logits.shape == (8, 1) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=1e-5, atol=1e-5)
    (logits * torch.arange(1.0, 9.0)[:, None]).sum().backward()
    np.testing.assert_allclose(_nhwc(img.grad), np.asarray(want_gx), rtol=1e-4,
                               atol=1e-6 * np.abs(want_gx).max())
    want_sd = convert_discriminator_params(jax.device_get(want_gp))
    for name, p in disc.named_parameters():
        w = want_sd[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=1e-6 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("res,channel_base", CASES)
def test_weights_map_both_ways(res, channel_base):
    _, params = _jax_disc(res, channel_base, seed=1)
    disc = _port_disc(res, channel_base, params)
    back = convert_discriminator_state_dict(
        {k: v.numpy() for k, v in disc.state_dict().items()}, res, channel_base=channel_base)
    flat = jax.tree_util.tree_leaves_with_path(back)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat) == len(want)
    for path, v in flat:
        np.testing.assert_array_equal(v, want[path])


@pytest.mark.parametrize("fused", [dict(fused_dbwd=True), dict(fused_skip=True),
                                   dict(fused_dbwd=True, fused_skip=True)],
                         ids=["dbwd", "skip", "both"])
def test_fused_discriminator_matches_plain(fused):
    res, base = 32, 512
    _, params = _jax_disc(res, base, seed=3)
    plain = _port_disc(res, base, params)
    fast = _port_disc(res, base, params, **fused)
    x = torch.from_numpy(np.random.RandomState(8).uniform(-1, 1, (8, 3, res, res))
                         .astype(np.float32))
    grads = []
    for disc in (plain, fast):
        img = x.clone().requires_grad_(True)
        logits = disc(img)
        (logits * torch.arange(1.0, 9.0)[:, None]).sum().backward()
        grads.append((logits.detach(), img.grad, {n: p.grad for n, p in disc.named_parameters()}))
    (l0, gx0, gp0), (l1, gx1, gp1) = grads
    assert torch.equal(l0, l1)
    torch.testing.assert_close(gx1, gx0, rtol=1e-5, atol=1e-6 * float(gx0.abs().max()))
    for name in gp0:
        torch.testing.assert_close(gp1[name], gp0[name], rtol=1e-5,
                                   atol=1e-6 * float(gp0[name].abs().max()), msg=name)
    # the plain path of a fused module is the plain module
    assert torch.equal(fast(x, fused=False), l0)


def test_r1_matches_jax_and_skips_the_fused_functions(monkeypatch):
    """R1 = 10 * mean_b |d sum D(x) / dx_b|^2 through the plain path of a fused
    D (``fused=False``): value and second-order parameter gradient equal the
    JAX package's ``r1_penalty``, and no fused Function is reached."""
    from vqvae_tpu_torch.ops import fused_dbwd as fd
    res, base = 16, 256
    module, params = _jax_disc(res, base, seed=4)
    disc = _port_disc(res, base, params, fused_dbwd=True, fused_skip=True)
    x = np.random.RandomState(9).uniform(-1, 1, (8, res, res, 3)).astype(np.float32)

    def jr1(p):
        return r1_penalty(lambda q, im: module.apply({"params": q}, im), p, jnp.asarray(x), 10.0)

    want, want_g = jax.value_and_grad(jr1)(params)

    def refuse(*a, **k):
        raise AssertionError("a fused Function was reached by the R1 path")

    monkeypatch.setattr(fd.FusedActBlur, "apply", refuse)
    monkeypatch.setattr(fd.FusedSkipFanout, "apply", refuse)
    img = _nchw(x).requires_grad_(True)
    logits = disc(img, fused=False)
    (g,) = torch.autograd.grad(logits.sum(), img, create_graph=True)
    r1 = 10.0 * g.square().reshape(8, -1).sum(1).mean()
    r1.backward()
    np.testing.assert_allclose(float(r1.detach()), float(want), rtol=1e-4)
    want_sd = convert_discriminator_params(jax.device_get(want_g))
    n_reached = 0
    for name, p in disc.named_parameters():
        w = want_sd[name].numpy()
        # a parameter the input gradient does not depend on (an lrelu's
        # bias only moves the branch mask) gets no gradient: JAX's is 0
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(w)
        n_reached += p.grad is not None
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * max(np.abs(w).max(), 1e-12),
                                   err_msg=name)
    assert n_reached >= len(want_sd) // 2


def test_r1_through_the_fused_module_raises():
    res, base = 16, 256
    _, params = _jax_disc(res, base, seed=5)
    disc = _port_disc(res, base, params, fused_dbwd=True)
    img = torch.zeros(4, 3, res, res).uniform_(-1, 1).requires_grad_(True)
    (g,) = torch.autograd.grad(disc(img).sum(), img, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|twice"):
        g.square().sum().backward()


def test_channels_follow_the_reference():
    disc = td.Discriminator(256, device="meta")
    want = {256: (128, 256), 128: (256, 512), 64: (512, 512), 32: (512, 512), 16: (512, 512),
            8: (512, 512)}
    for res, (tmp, out) in want.items():
        block = getattr(disc, f"b{res}")
        assert tuple(block.conv1.weight.shape[:2]) == (out, tmp), res
    assert disc.b4.fc.weight.shape == (512, 512 * 16)
    assert hasattr(disc.b256, "fromrgb") and not hasattr(disc.b128, "fromrgb")
    n = sum(p.numel() for p in disc.parameters())
    assert 28e6 < n < 30e6, n   # the reference D at 256^2 has 28.9M parameters
