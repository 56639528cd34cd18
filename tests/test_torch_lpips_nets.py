"""LPIPS-AlexNet and LPIPS-SqueezeNet of the port against
``vqvae_tpu.models.lpips`` on the CPU, fp32, with shared random weights
copied through ``convert_lpips_params`` (the converted ``.npz`` files are
not in the repository; both sides run seeded random weights):

- SqueezeNet's ceil-mode 3x3/2 pool equals JAX's ``_max_pool_ceil`` at odd
  and even sizes;
- each net's distance, reduced and per sample, and its input gradient at
  an odd input size (37: the ceil-mode pools round up twice), rtol 1e-4
  (the gradient: atol 1e-5 of its largest entry; 8 of 12321 SqueezeNet
  entries differ by up to 2e-6 of it);
- ``init_lpips`` reads ``lpips_<net>.npz`` from the JAX package's cache path
  and warns without it;
- a ``loss:`` block without a GAN takes LPIPS-AlexNet in both Trainers
  (both read one random ``lpips_alex.npz``): 3 steps of a tiny standard-VQ
  config (32^2, the smallest size AlexNet's pools take) from the JAX
  Trainer's weights: step 1's metrics rtol 1e-4,
  every step's rtol 5e-3 / atol 1e-5 (the trajectory tolerances of
  ``torch_train_parity.py``), ``perc_loss`` > 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vqvae_tpu.models import lpips as jl
from vqvae_tpu_torch.models import lpips as tl
from vqvae_tpu_torch.utils.convert import convert_lpips_params, convert_vqvae_variables

torch.set_num_threads(1)

SIZE, BATCH = 37, 2
NETS = ("alex", "squeeze")


def _random_params(net: str) -> dict:
    """Random weights in the JAX module's tree (its shapes from
    ``eval_shape``, nothing compiled): lecun-normal kernels, small biases,
    lin heads in (0.1, 1)."""
    module = jl.LPIPS(net_type=net)
    x0 = jnp.zeros((1, SIZE, SIZE, 3))
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x0, x0)["params"]
    rs = np.random.RandomState(1)
    return jax.tree_util.tree_map_with_path(
        lambda path, p: (rs.uniform(0.1, 1.0, p.shape) if path[-1].key.startswith("lin")
                         else 0.05 * rs.randn(*p.shape) if path[-1].key == "bias"
                         else rs.randn(*p.shape) / np.sqrt(np.prod(p.shape[:-1]))
                         ).astype(np.float32), shapes)


@pytest.fixture(scope="module", params=NETS)
def pair(request):
    """(net, JAX params, the port's LPIPS on them, and JAX's per-sample
    distances with the input gradients of their weighted sum and of their
    mean, in one compiled call)."""
    net = request.param
    params = _random_params(net)
    module = jl.LPIPS(net_type=net)
    x, y = _images()

    @jax.jit
    def reference(yy):
        def dist(yy, reduce):
            return module.apply({"params": params}, jnp.asarray(x), yy, reduce=reduce)
        weights = jnp.arange(1.0, 1.0 + BATCH)
        return (dist(yy, False), jax.grad(lambda v: jnp.sum(dist(v, False) * weights))(yy),
                dist(yy, True), jax.grad(lambda v: dist(v, True))(yy))

    want = [np.asarray(v) for v in reference(jnp.asarray(y))]
    return net, params, tl.init_lpips(net, device="cpu", params=params), want


def _images():
    rs = np.random.RandomState(2)
    return tuple(rs.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("h,w", [(9, 9), (10, 13), (17, 8)])
def test_ceil_mode_pool_matches_jax(h, w):
    x = np.random.RandomState(h * w).randn(2, h, w, 5).astype(np.float32)
    want = np.asarray(jl._max_pool_ceil(jnp.asarray(x)))
    got = F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, ceil_mode=True)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("reduce", [True, False])
def test_lpips_net_matches_jax(pair, reduce):
    net, params, port, (per_sample, per_sample_g, mean, mean_g) = pair
    want, want_g = (mean, mean_g) if reduce else (per_sample, per_sample_g)
    x, y = _images()
    ty = torch.from_numpy(y).requires_grad_(True)
    got = port(torch.from_numpy(x), ty, reduce=reduce)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, err_msg=net)
    weights = torch.ones(()) if reduce else torch.arange(1.0, 1.0 + BATCH)
    (got * weights).sum().backward()
    np.testing.assert_allclose(ty.grad.numpy(), want_g, rtol=1e-4,
                               atol=1e-5 * np.abs(want_g).max(), err_msg=net)
    assert len(port.net(torch.zeros(1, 3, SIZE, SIZE))) == len(
        {"alex": tl.ALEX_CHANNELS, "squeeze": tl.SQUEEZE_CHANNELS}[net])


def test_init_lpips_reads_the_converted_npz(pair, tmp_path, monkeypatch):
    net, params, port, _ = pair
    monkeypatch.setenv("VQVAE_TPU_LPIPS_WEIGHTS_DIR", str(tmp_path))
    with pytest.warns(UserWarning, match="LPIPS pretrained weights not found"):
        tl.init_lpips(net, device="cpu")
    np.savez(tmp_path / f"lpips_{net}.npz", **jl.flatten_params(params))
    loaded = tl.init_lpips(net, device="cpu")
    assert set(convert_lpips_params(params)) == set(loaded.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    assert not any(p.requires_grad for p in loaded.parameters())


def test_alex_loss_trajectory_matches_jax(tmp_path, monkeypatch):
    from vqvae_tpu.config import parse_config as jax_parse_config
    from vqvae_tpu.train.loop import Trainer as JaxTrainer
    from vqvae_tpu_torch.config import parse_config
    from vqvae_tpu_torch.train.loop import Trainer

    # both Trainers read the same random AlexNet weights from the cache path
    np.savez(tmp_path / "lpips_alex.npz", **jl.flatten_params(_random_params("alex")))
    monkeypatch.setenv("VQVAE_TPU_LPIPS_WEIGHTS_DIR", str(tmp_path))
    img, batch, lr, steps = 32, 4, 1e-3, 3
    raw = {
        "image_size": img,
        "autoencoder": {"channels": 32, "num_res_blocks": 1, "channel_multipliers": [1, 2]},
        "quantizer": {"type": "standard", "num_embeddings": 32, "embedding_dim": 8,
                      "reinit_every_n_epochs": None, "params": {"commitment_cost": 0.25}},
        "loss": {"l1_weight": 0.8, "l2_weight": 0.2, "perc_weight": 1.0},
        "training": {"cumulative_bs": batch, "base_lr": lr, "betas": [0.0, 0.99],
                     "eps": 1e-8, "weight_decay": 1e-4, "decay_epochs": 1, "max_epochs": 300},
    }
    jt = JaxTrainer(cfg=jax_parse_config(raw), learning_rate=lr, seed=0, steps_per_epoch=steps,
                    mesh=None, compute_dtype=jnp.float32, remat=False, augment=False)
    # the same initial weights, compiled once instead of traced op by op
    jt.model.init = jax.jit(jt.model.init, static_argnames=("train",))
    try:
        state = jt.init_state()
        variables = jax.tree.map(np.array, {"params": state.params})
        tt = Trainer(parse_config(raw), learning_rate=lr, seed=0, steps_per_epoch=steps,
                     augment=False, device="cpu")
        assert type(tt.losses.lpips.net).__name__ == "AlexNetFeatures"
        ts = tt.init_state()
        ts.model.load_state_dict(convert_vqvae_variables(variables, 1, 2), strict=True)
        batches = np.random.RandomState(42).rand(steps, batch, img, img, 3).astype(np.float32)
        traj_jax, traj_port = [], []
        for b in batches:
            state, mj = jt.train_step(state, {"image": jnp.asarray(b)}, epoch=0)
            ts, mt = tt.train_step(ts, {"image": b}, epoch=0)
            traj_jax.append({k: float(v) for k, v in jax.device_get(mj).items()})
            traj_port.append({k: float(v) for k, v in mt.items()})
    finally:
        jt.native_lr.destroy()
    assert set(traj_port[0]) == set(traj_jax[0])
    for k, v in traj_port[0].items():
        np.testing.assert_allclose(v, traj_jax[0][k], rtol=1e-4, err_msg=k)
    for k in ("loss", "l1_loss", "l2_loss", "quant_loss", "perc_loss"):
        np.testing.assert_allclose([m[k] for m in traj_port], [m[k] for m in traj_jax],
                                   rtol=5e-3, atol=1e-5, err_msg=k)
    assert all(m["perc_loss"] > 0 for m in traj_port)
