"""The port's small ops (``vqvae_tpu_torch/ops/misc_ops.py``) against the JAX
package's (``vqvae_tpu/ops/misc_ops.py``) in float64 on the CPU (JAX under
``jax.enable_x64``), NCHW against NHWC, inputs from a numpy seed:

- ``fma``: value and gradients, rtol 1e-12;
- ``grid_sample`` (bilinear, zero padding, ``align_corners=False``; the grid
  reaches past the image's edges): the value against JAX's and torch's
  ``F.grid_sample``, the gradients of a weighted sum in the image and the
  grid, and the second-order gradient (of the squared norm of the grid
  gradient, in the grid and in the image), each rtol 1e-9 / atol 1e-12;
- ``modulated_conv2d`` with and without demodulation, rtol 1e-10;
- ``set_matmul_precision`` sets PyTorch's TF32 switches by JAX's names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vqvae_tpu.ops import misc_ops as jax_ops
from vqvae_tpu_torch.ops import misc_ops

RTOL, ATOL = 1e-9, 1e-12


def _t(a: np.ndarray, grad: bool = False) -> torch.Tensor:
    return torch.tensor(a, dtype=torch.float64, requires_grad=grad)


def _nhwc(a: np.ndarray) -> np.ndarray:
    return a.transpose(0, 2, 3, 1)


def _inputs():
    rs = np.random.RandomState(4)
    x = rs.randn(2, 3, 7, 9)
    grid = (rs.rand(2, 5, 6, 2) * 2 - 1) * 1.2   # some taps fall outside
    weight = rs.randn(2, 3, 5, 6)
    return x, grid, weight


def test_fma():
    rs = np.random.RandomState(0)
    a, b, c = (rs.randn(4, 5) for _ in range(3))
    ta, tb, tc = _t(a, True), _t(b, True), _t(c, True)
    out = misc_ops.fma(ta, tb, tc)
    grads = torch.autograd.grad((out * out).sum(), (ta, tb, tc))
    with jax.enable_x64(True):
        want = jax_ops.fma(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
        want_grads = jax.grad(lambda *v: jnp.sum(jax_ops.fma(*v) ** 2), argnums=(0, 1, 2))(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-12)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


def test_grid_sample_value_matches_jax_and_torch():
    x, grid, _ = _inputs()
    got = misc_ops.grid_sample(_t(x), _t(grid)).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jax_ops.grid_sample(jnp.asarray(_nhwc(x)), jnp.asarray(grid)))
    np.testing.assert_allclose(_nhwc(got), want, rtol=RTOL, atol=ATOL)
    torch_ref = F.grid_sample(_t(x), _t(grid), mode="bilinear", padding_mode="zeros",
                              align_corners=False).numpy()
    np.testing.assert_allclose(got, torch_ref, rtol=RTOL, atol=ATOL)
    assert np.abs(got).max() > 0.1 and (np.abs(grid) > 1).any()


def _jax_loss(x_nhwc, grid, weight_nhwc):
    return jnp.sum(jax_ops.grid_sample(x_nhwc, grid) * weight_nhwc)


def test_grid_sample_first_order_gradients():
    x, grid, weight = _inputs()
    tx, tg = _t(x, True), _t(grid, True)
    gx, gg = torch.autograd.grad((misc_ops.grid_sample(tx, tg) * _t(weight)).sum(), (tx, tg))
    with jax.enable_x64(True):
        want_x, want_g = jax.grad(_jax_loss, argnums=(0, 1))(
            jnp.asarray(_nhwc(x)), jnp.asarray(grid), jnp.asarray(_nhwc(weight)))
    np.testing.assert_allclose(_nhwc(gx.numpy()), np.asarray(want_x), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gg.numpy(), np.asarray(want_g), rtol=RTOL, atol=ATOL)
    assert np.abs(gg.numpy()).max() > 0.1


def test_grid_sample_second_order_gradients():
    """d/d(grid, x) of |d/dgrid sum(grid_sample(x, grid)^2)|^2."""
    x, grid, _ = _inputs()
    tx, tg = _t(x, True), _t(grid, True)
    (g1,) = torch.autograd.grad((misc_ops.grid_sample(tx, tg) ** 2).sum(), tg, create_graph=True)
    ggx, ggg = torch.autograd.grad((g1 ** 2).sum(), (tx, tg))

    def outer(x_nhwc, g):
        inner = jax.grad(lambda gg: jnp.sum(jax_ops.grid_sample(x_nhwc, gg) ** 2))(g)
        return jnp.sum(inner ** 2)

    with jax.enable_x64(True):
        want_x, want_g = jax.grad(outer, argnums=(0, 1))(jnp.asarray(_nhwc(x)),
                                                         jnp.asarray(grid))
    np.testing.assert_allclose(_nhwc(ggx.numpy()), np.asarray(want_x), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ggg.numpy(), np.asarray(want_g), rtol=RTOL, atol=ATOL)
    assert np.abs(ggg.numpy()).max() > 0.1


@pytest.mark.parametrize("demodulate", [True, False])
def test_modulated_conv2d(demodulate):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 4, 8, 8)
    w = rs.randn(6, 4, 3, 3) * 0.3
    styles = rs.rand(2, 4) + 0.5
    got = misc_ops.modulated_conv2d(_t(x), _t(w), _t(styles), demodulate=demodulate,
                                    padding=1).numpy()
    with jax.enable_x64(True):
        want = jax_ops.modulated_conv2d(jnp.asarray(_nhwc(x)), jnp.asarray(w.transpose(2, 3, 1, 0)),
                                        jnp.asarray(styles), demodulate=demodulate, padding=1)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-10, atol=1e-12)


def test_set_matmul_precision_sets_the_tf32_switches():
    saved = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    try:
        for name, tf32 in (("tensorfloat32", True), ("highest", False), ("high", True),
                           ("float32", False)):
            misc_ops.set_matmul_precision(name)
            assert torch.backends.cuda.matmul.allow_tf32 is tf32
            assert torch.backends.cudnn.allow_tf32 is tf32
        misc_ops.set_matmul_precision(None)
        assert torch.get_float32_matmul_precision() == "highest"
        with pytest.raises(ValueError, match="precision must be one of"):
            misc_ops.set_matmul_precision("fastest")
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
