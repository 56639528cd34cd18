"""The port's entropy quantizer against the JAX package's on the CPU:

- ``entropy_loss`` for both loss types, with and without row weights, at a
  sharp and a softer temperature: value rtol 1e-5, gradient within 1e-5 of the
  largest entry;
- ``EntropyVectorQuantizer`` alone, both loss types, masked and not: codes
  exact, quantized latents within 1e-6, the loss rtol 1e-5, the gradient of
  loss + latents' sum to the latents and the codebook within 1e-5 of each
  one's largest entry;
- a tiny entropy VQVAE built from ``convert_vqvae_variables`` of the JAX
  variables: forward codes exact, q_loss rtol 1e-5, reconstructions atol
  1e-4, ``get_tokens`` (``vec_to_codes`` through ``nearest_codes``) exact;
- ``Trainer.train_step`` on a tiny entropy config against the JAX
  ``Trainer`` (``torch_train_parity.py``: first-step gradients rtol 1e-3,
  metrics 1e-4, 24-step trajectory 5e-3, a masked eval step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_parity as parity
from test_torch_autoencoder import numpy_params
from vqvae_tpu.config import parse_config as jax_parse_config
from vqvae_tpu.models import quantizers as jq
from vqvae_tpu.models.vqvae import VQVAE as JaxVQVAE
from vqvae_tpu_torch.config import parse_config
from vqvae_tpu_torch.models import quantizers as tq
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.ops.vq import nearest_codes
from vqvae_tpu_torch.utils.convert import convert_vqvae_variables

torch.set_num_threads(1)

RAW = {
    "image_size": 16,
    "autoencoder": {"channels": 32, "num_res_blocks": 1, "channel_multipliers": [1, 2]},
    "quantizer": {"type": "entropy", "num_embeddings": 32, "embedding_dim": 8,
                  "params": {"commitment_cost": 0.25, "ent_loss_ratio": 0.1,
                             "ent_temperature": 0.01, "ent_loss_type": "softmax"}},
}


def _affinity(seed=0, m=64, n=32, d=8):
    """Negative squared distances of seeded latents to a seeded codebook, at
    a scale where temperature 0.01 leaves the softmax a few codes wide."""
    rs = np.random.RandomState(seed)
    x, cb = 0.1 * rs.randn(m, d), 0.05 * rs.randn(n, d)
    return -((x[:, None] - cb[None]) ** 2).sum(-1).astype(np.float32)


@pytest.mark.parametrize("temperature", [0.01, 0.05])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("loss_type", ["softmax", "argmax"])
def test_entropy_loss_matches_jax(loss_type, masked, temperature):
    aff = _affinity()
    rw = (np.random.RandomState(1).rand(aff.shape[0]) > 0.3).astype(np.float32) if masked else None
    value_j, grad_j = jax.value_and_grad(lambda a: jq.entropy_loss(
        a, temperature, loss_type, None if rw is None else jnp.asarray(rw)))(jnp.asarray(aff))
    a = torch.from_numpy(aff).requires_grad_()
    value = tq.entropy_loss(a, temperature, loss_type,
                            None if rw is None else torch.from_numpy(rw))
    value.backward()
    np.testing.assert_allclose(value.item(), float(value_j), rtol=1e-5)
    grad_j = np.asarray(grad_j)
    np.testing.assert_allclose(a.grad.numpy(), grad_j, rtol=0,
                               atol=1e-5 * np.abs(grad_j).max())
    assert np.abs(grad_j).max() > 0


def test_entropy_loss_rejects_an_unknown_type():
    with pytest.raises(ValueError, match="not supported"):
        tq.entropy_loss(torch.zeros(4, 3), 1.0, "hinge")


def test_masked_rows_change_nothing():
    """A masked row's affinities, whatever they are, move neither term."""
    aff = torch.from_numpy(_affinity(2))
    rw = torch.ones(aff.shape[0])
    rw[5:9] = 0
    garbage = aff.clone()
    garbage[5:9] = 1e3 * torch.randn(4, aff.shape[1], generator=torch.Generator().manual_seed(0))
    for loss_type in ("softmax", "argmax"):
        a = tq.entropy_loss(aff, 0.01, loss_type, rw)
        b = tq.entropy_loss(garbage, 0.01, loss_type, rw)
        kept = tq.entropy_loss(aff[rw > 0], 0.01, loss_type)
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
        torch.testing.assert_close(a, kept, rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax variables, port model) with the same numpy weights,
    the port's loaded through ``convert_vqvae_variables``."""
    cfg = jax_parse_config(RAW)
    jmodel = JaxVQVAE.from_config(cfg)
    variables = numpy_params(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))),
                             seed=31)
    assert set(variables["params"]["quantizer"]) == {"codebook"} and "vq_state" not in variables
    tmodel = VQVAE.from_config(parse_config(RAW), device="cpu",
                               generator=torch.Generator().manual_seed(0))
    assert isinstance(tmodel.quantizer, tq.EntropyVectorQuantizer)
    tmodel.load_state_dict(convert_vqvae_variables(variables, 1, 2), strict=True)
    return jmodel, variables, tmodel


@pytest.mark.parametrize("masked", [False, True])
def test_vqvae_forward_matches_jax(pair, masked):
    """The whole tiny VQVAE, weights converted from the JAX variables."""
    jmodel, variables, tmodel = pair
    x = np.random.RandomState(26).uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    mask = np.array([True, False, True, True]) if masked else None
    recon_j, q_loss_j, codes_j = jmodel.apply(
        variables, jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        recon, q_loss, codes = tmodel(torch.from_numpy(x),
                                      mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(q_loss.item(), float(q_loss_j), rtol=1e-5)
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), rtol=0, atol=1e-4)


@pytest.mark.parametrize("loss_type", ["softmax", "argmax"])
@pytest.mark.parametrize("masked", [False, True])
def test_quantizer_forward_and_gradients_match_jax(masked, loss_type):
    """The quantizer alone, latents and codebook at a scale where temperature
    0.01 leaves the softmax a few codes wide."""
    rs = np.random.RandomState(32)
    z = (0.1 * rs.randn(4, 4, 4, 8)).astype(np.float32)
    cb = (0.05 * rs.randn(32, 8)).astype(np.float32)
    mask = np.array([True, False, True, True]) if masked else None
    jmodule = jq.EntropyVectorQuantizer(32, 8, ent_loss_ratio=0.1, ent_temperature=0.01,
                                        ent_loss_type=loss_type, commitment_cost=0.25)

    def jax_fn(z, codebook):
        quantized, codes, loss = jmodule.apply(
            {"params": {"codebook": codebook}}, z, train=True,
            mask=None if mask is None else jnp.asarray(mask))
        return loss + quantized.sum(), (quantized, codes, loss)

    (_, (q_j, codes_j, loss_j)), (gz_j, gc_j) = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)(jnp.asarray(z), jnp.asarray(cb))

    q = tq.make_quantizer("entropy", 32, 8, {"ent_loss_ratio": 0.1, "ent_temperature": 0.01,
                                             "ent_loss_type": loss_type,
                                             "commitment_cost": 0.25})
    q.load_state_dict({"codebook.weight": torch.from_numpy(cb)})
    zt = torch.from_numpy(z).permute(0, 3, 1, 2).contiguous().requires_grad_()
    quantized, codes, loss = q(zt, train=True,
                               mask=None if mask is None else torch.from_numpy(mask))
    (loss + quantized.sum()).backward()

    assert codes.dtype == torch.int32 and codes.shape == (4, 16)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(quantized.detach().permute(0, 2, 3, 1).numpy(), np.asarray(q_j),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for got, want in ((zt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gz_j)),
                      (q.codebook.weight.grad.numpy(), np.asarray(gc_j))):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_get_tokens_exact(pair, monkeypatch):
    jmodel, variables, tmodel = pair
    images = np.random.RandomState(33).uniform(0, 1, (4, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(images), method="get_tokens"))
    calls = []
    assert tq.nearest_codes is nearest_codes

    def spy(flat_x, codebook):
        calls.append(flat_x.shape)
        return nearest_codes(flat_x, codebook)

    monkeypatch.setattr(tq, "nearest_codes", spy)
    got = tmodel.get_tokens(torch.from_numpy(images))
    assert calls == [(4 * 16, 8)]            # vec_to_codes goes through B1's dispatcher
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 4


def test_make_quantizer_builds_every_published_type():
    params = {"commitment_cost": 0.25, "decay": 0.95, "epsilon": 1e-5, "straight_through": False,
              "temp": 1.0, "kl_cost": 5e-4, "ent_loss_ratio": 0.1, "ent_temperature": 0.01,
              "ent_loss_type": "argmax"}
    types = {"standard": tq.VectorQuantizer, "ema": tq.EMAVectorQuantizer,
             "gumbel": tq.GumbelVectorQuantizer, "entropy": tq.EntropyVectorQuantizer}
    for name, cls in types.items():
        assert type(tq.make_quantizer(name, 32, 8, params)) is cls
    q = tq.make_quantizer("entropy", 32, 8, params)
    assert (q.ent_loss_type, q.ent_temperature, q.ent_loss_ratio) == ("argmax", 0.01, 0.1)
    with pytest.raises(ValueError, match="unrecognized"):
        tq.make_quantizer("nope", 32, 8, params)


@pytest.fixture(scope="module")
def train_pair():
    return parity.run_pair("entropy")


def test_trainer_one_step_gradients_match_jax(train_pair):
    parity.check_gradients(train_pair)


def test_trainer_one_step_metrics_match_jax(train_pair):
    parity.check_first_step(train_pair)


def test_trainer_trajectory_matches_jax(train_pair):
    parity.check_trajectory(train_pair)


def test_trainer_eval_step_matches_jax(train_pair):
    parity.check_eval(train_pair)
