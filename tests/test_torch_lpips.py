"""LPIPS-VGG of the PyTorch port against ``vqvae_tpu.models.lpips.LPIPS`` on
the CPU, fp32, on shared random weights copied through
``vqvae_tpu_torch.utils.convert.convert_lpips_params``: the distance reduced
and per sample, and its input gradient, rtol 1e-4 (atol 1e-6 of the
gradient's scale); the channel normalization's hand-written backward equals
autograd of its formula and stays finite at all-zero pixels; ``init_lpips``
reads the converted ``.npz`` when it is there and warns when it is not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.models import lpips as jl
from vqvae_tpu_torch.models import lpips as tl
from vqvae_tpu_torch.utils.convert import convert_lpips_params

torch.set_num_threads(1)

SIZE, BATCH = 16, 3


@pytest.fixture(scope="module")
def pair():
    module = jl.LPIPS(net_type="vgg")
    x0 = jnp.zeros((1, SIZE, SIZE, 3))
    params = module.init(jax.random.PRNGKey(0), x0, x0)["params"]
    rs = np.random.RandomState(1)
    # the init's lin heads are ones and its biases zeros: draw both
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: (rs.uniform(0.1, 1.0, p.shape) if path[-1].key.startswith("lin")
                         else 0.05 * rs.randn(*p.shape) if path[-1].key == "bias"
                         else np.asarray(p)).astype(np.float32), jax.device_get(params))
    port = tl.init_lpips("vgg", device="cpu", params=params)
    return module, params, port


def _images(seed):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32),
            rs.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32))


@pytest.mark.parametrize("reduce", [True, False])
def test_lpips_matches_jax(pair, reduce):
    module, params, port = pair
    x, y = _images(2)

    def jdist(yy):
        return module.apply({"params": params}, jnp.asarray(x), yy, reduce=reduce)

    want = np.asarray(jdist(jnp.asarray(y)))
    want_g = np.asarray(jax.grad(lambda yy: jnp.sum(jdist(yy) * jnp.arange(1.0, 1.0 + want.size)
                                                    .reshape(want.shape)))(jnp.asarray(y)))
    ty = torch.from_numpy(y).requires_grad_(True)
    got = port(torch.from_numpy(x), ty, reduce=reduce)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4)
    (got * torch.arange(1.0, 1.0 + want.size).reshape(want.shape)).sum().backward()
    np.testing.assert_allclose(ty.grad.numpy(), want_g, rtol=1e-4,
                               atol=1e-6 * np.abs(want_g).max())


def test_lpips_is_frozen(pair):
    _, _, port = pair
    assert not any(p.requires_grad for p in port.parameters())
    x, y = _images(3)
    assert float(port(torch.from_numpy(x), torch.from_numpy(x))) == 0.0
    assert float(port(torch.from_numpy(x), torch.from_numpy(y))) > 0.0


def test_normalize_backward_equals_autograd_and_is_finite_at_zero():
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 6, 3, 3, generator=gen).requires_grad_(True)
    ct = torch.randn(x.shape, generator=gen)
    (got,) = torch.autograd.grad(tl.normalize_activation(x), x, ct)
    # autograd of the formula in float64 (the statistics are fp32 by design)
    x64 = x.detach().double().requires_grad_(True)
    formula = x64 / (x64.square().sum(1, keepdim=True).sqrt() + 1e-10)
    (want,) = torch.autograd.grad(formula, x64, ct.double())
    torch.testing.assert_close(got, want.float(), rtol=1e-5, atol=1e-6)

    z = x.detach().clone()
    z[:, :, 1, 1] = 0.0          # an all-zero pixel, as after a ReLU
    z.requires_grad_(True)
    (g,) = torch.autograd.grad(tl.normalize_activation(z), z, ct)
    assert bool(torch.isfinite(g).all())
    formula = z / (z.square().sum(1, keepdim=True).sqrt() + 1e-10)
    (g_auto,) = torch.autograd.grad(formula, z, ct)
    assert not bool(torch.isfinite(g_auto).all())   # autograd of the formula: NaN there


def test_init_lpips_reads_the_npz_or_warns(pair, tmp_path, monkeypatch):
    _, params, port = pair
    monkeypatch.setenv("VQVAE_TPU_LPIPS_WEIGHTS_DIR", str(tmp_path))
    assert tl.lpips_weights_path("vgg") == tmp_path / "lpips_vgg.npz"
    with pytest.warns(UserWarning, match="not found"):
        fresh = tl.init_lpips("vgg", seed=3, device="cpu")
    np.savez(tmp_path / "lpips_vgg.npz", **jl.flatten_params(params))
    loaded = tl.init_lpips("vgg", seed=3, device="cpu")
    for k, v in port.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    assert not torch.equal(fresh.net.conv0.weight, loaded.net.conv0.weight)
    assert set(convert_lpips_params(params)) == set(port.state_dict())


def test_unported_nets_name_their_roadmap_item():
    """Every net of the JAX package is ported; an unknown one raises, naming
    the three."""
    with pytest.raises(NotImplementedError, match="vgg | alex | squeeze"):
        tl.LPIPS("resnet", device="cpu")
    for net in ("alex", "squeeze"):
        assert tl.LPIPS(net, device="cpu").net.__class__.__name__.lower().startswith(net)
