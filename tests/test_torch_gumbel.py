"""The gumbel quantizer of the PyTorch port against the JAX package on the
CPU, fp32, with the gumbel noise zeroed on both sides (the two draw from
unrelated generators; the method of ``test_mse_trajectory_parity_gumbel``):
soft (train) and hard (eval) quantization, codes exact, quantized rtol 1e-5,
KL loss rtol 1e-5 with and without a row mask, and the gradients of a loss
of both outputs (rtol 1e-4); the whole gumbel VQVAE (reconstructions atol
1e-4, tokens exact); ``vec_to_codes`` with ``deterministic=True`` and its
noise on the raw channels; ``build_gumbel_schedules`` (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_autoencoder import numpy_params
from vqvae_tpu.config import parse_config as jax_parse_config
from vqvae_tpu.models import quantizers as jq
from vqvae_tpu.models.vqvae import VQVAE as JaxVQVAE
from vqvae_tpu.train import schedules as jsched
from vqvae_tpu_torch.config import parse_config
from vqvae_tpu_torch.models import quantizers as tq
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.train import schedules as tsched
from vqvae_tpu_torch.utils.convert import convert_vqvae_variables

torch.set_num_threads(1)

N, D = 16, 8


@pytest.fixture
def no_noise(monkeypatch):
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(tq, "gumbel_noise",
                        lambda shape, device, generator=None: torch.zeros(shape, device=device))


def _quantizer_pair(seed=0):
    jmod = jq.GumbelVectorQuantizer(N, D, straight_through=False, temp=0.7, kl_cost=0.01)
    z0 = jnp.zeros((1, 2, 2, N))
    variables = jmod.init({"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)},
                          z0, train=True)
    rs = np.random.RandomState(seed)
    params = jax.tree.map(lambda p: rs.randn(*p.shape).astype(np.float32) * 0.5,
                          jax.device_get(variables["params"]))
    port = tq.GumbelVectorQuantizer(N, D, temp=0.7, kl_cost=0.01)
    port.load_state_dict({
        "codebook.weight": torch.from_numpy(params["codebook"]),
        "x_to_logits.weight": torch.from_numpy(params["x_to_logits_kernel"].transpose(3, 2, 0, 1)
                                               .copy()),
        "x_to_logits.bias": torch.from_numpy(params["x_to_logits_bias"])}, strict=True)
    return jmod, params, port


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_quantizer_matches_flax(no_noise, train, masked):
    jmod, params, port = _quantizer_pair()
    z = np.random.RandomState(3).randn(4, 3, 5, N).astype(np.float32)   # NHWC
    mask = np.array([True, False, True, True]) if masked else None
    wq = np.random.RandomState(4).randn(4, 3, 5, D).astype(np.float32)

    def jloss(p, zz):
        q, codes, kl = jmod.apply({"params": p}, zz, train=train, temp=0.5, kl_cost=0.02,
                                  rngs={"gumbel": jax.random.PRNGKey(0)},
                                  mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(q * wq) + 100.0 * kl, (q, codes, kl)

    (_, (q, codes, kl)), (gp, gz) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(z))
    tz = torch.from_numpy(z.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    tq_, tcodes, tkl = port(tz, train=train, temp=0.5, kl_cost=0.02,
                            mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(codes))
    np.testing.assert_allclose(tq_.detach().permute(0, 2, 3, 1).numpy(), np.asarray(q),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tkl.detach()), float(kl), rtol=1e-5)
    loss = (tq_.permute(0, 2, 3, 1) * torch.from_numpy(wq)).sum() + 100.0 * tkl
    loss.backward()
    np.testing.assert_allclose(tz.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gz), rtol=1e-4,
                               atol=1e-6 * np.abs(np.asarray(gz)).max())
    grads = dict(port.named_parameters())
    for name, want in (("codebook.weight", gp["codebook"]),
                       ("x_to_logits.weight", np.asarray(gp["x_to_logits_kernel"])
                        .transpose(3, 2, 0, 1)),
                       ("x_to_logits.bias", gp["x_to_logits_bias"])):
        want = np.asarray(want)
        np.testing.assert_allclose(grads[name].grad.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max(), err_msg=name)


def test_vec_to_codes(no_noise):
    jmod, params, port = _quantizer_pair(1)
    z = np.random.RandomState(5).randn(2, 4, 4, N).astype(np.float32)
    tz = torch.from_numpy(z.transpose(0, 3, 1, 2).copy())
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(z), deterministic=True,
                                 method="vec_to_codes"))
    np.testing.assert_array_equal(port.vec_to_codes(tz, deterministic=True).numpy(), want)
    assert port.vec_to_codes(tz, deterministic=True).dtype == torch.int32
    # the noise goes on the raw channels: zero noise gives the plain argmax
    np.testing.assert_array_equal(port.vec_to_codes(tz).numpy(), want)


def test_noise_is_gumbel_and_follows_its_generator():
    g = tq.gumbel_noise((200_000,), "cpu", torch.Generator().manual_seed(0))
    assert torch.equal(g, tq.gumbel_noise((200_000,), "cpu", torch.Generator().manual_seed(0)))
    # standard Gumbel: mean = Euler's gamma, variance = pi^2 / 6
    assert abs(float(g.mean()) - 0.5772) < 0.01 and abs(float(g.var()) - 1.6449) < 0.03
    logits = torch.randn(5, N, generator=torch.Generator().manual_seed(2))
    y = tq.gumbel_softmax(logits, 1.0, hard=True, generator=torch.Generator().manual_seed(1))
    # hard: one-hot + soft - soft, so 0 off the argmax and 1 within an fp32
    # rounding of (1 + soft) - soft on it
    hot = torch.nn.functional.one_hot(y.argmax(-1), N).bool()
    assert bool((y[~hot] == 0).all())
    torch.testing.assert_close(y[hot], torch.ones(5), rtol=0, atol=2 ** -23)


RAW = {
    "image_size": 16,
    "autoencoder": {"channels": 32, "num_res_blocks": 1, "channel_multipliers": [1, 2]},
    "quantizer": {"type": "gumbel", "num_embeddings": N, "embedding_dim": D,
                  "params": {"straight_through": False, "temp": 1.0, "kl_cost": 0.01}},
}


def test_gumbel_vqvae_matches_jax(no_noise):
    jmodel = JaxVQVAE.from_config(jax_parse_config(RAW))
    x0 = jnp.zeros((1, 16, 16, 3))
    variables = numpy_params(jmodel.init({"params": jax.random.PRNGKey(0),
                                          "gumbel": jax.random.PRNGKey(1)}, x0), seed=7)
    model = VQVAE.from_config(parse_config(RAW), device="cpu")
    model.load_state_dict(convert_vqvae_variables(variables, 1, 2), strict=True)
    assert model.encoder.conv_out.weight.shape[0] == N
    images = np.random.RandomState(8).rand(2, 16, 16, 3).astype(np.float32)
    x = jnp.asarray(images) * 2 - 1
    for train in (True, False):
        want, want_q, want_codes = jmodel.apply(variables, x, train=train, temp=0.8, kl_cost=0.03,
                                                rngs={"gumbel": jax.random.PRNGKey(2)})
        got, got_q, got_codes = model(torch.from_numpy(np.array(x)), train=train, temp=0.8,
                                      kl_cost=0.03)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(got_q), float(want_q), rtol=1e-4)
        np.testing.assert_array_equal(got_codes.numpy(), np.asarray(want_codes))
    want_tokens = jmodel.apply(variables, jnp.asarray(images), deterministic=True,
                               method="get_tokens")
    np.testing.assert_array_equal(
        model.get_tokens(torch.from_numpy(images), deterministic=True).numpy(),
        np.asarray(want_tokens))


@pytest.mark.parametrize("kl_warmup,decay,final", [(0.48, 15, 0.0625), (None, None, None),
                                                   (2.0, None, 0.1), (None, 3.0, 0.2)])
def test_gumbel_schedules_match_jax(kl_warmup, decay, final):
    jt, jk = jsched.build_gumbel_schedules(1.0, 0.0086, 10, kl_warmup, decay, final)
    tt, tk = tsched.build_gumbel_schedules(1.0, 0.0086, 10, kl_warmup, decay, final)
    steps = range(0, 60, 3)
    np.testing.assert_allclose([tt(i) for i in steps], [float(jt(i)) for i in steps], rtol=1e-6)
    np.testing.assert_allclose([tk(i) for i in steps], [float(jk(i)) for i in steps], rtol=1e-6,
                               atol=1e-12)
