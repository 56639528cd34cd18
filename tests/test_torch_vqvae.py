"""The ported slice as a whole against ``vqvae_tpu.models.vqvae.VQVAE`` on
the CPU, at a tiny standard-VQ config: tokens exact, reconstructions within
atol 1e-4, q_loss within rtol 1e-4, weights round-trip through both
converters unchanged, codebook-usage helpers equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_autoencoder import numpy_params
from vqvae_tpu.config import parse_config
from vqvae_tpu.models import quantizers as jq
from vqvae_tpu.models.vqvae import VQVAE as JaxVQVAE
from vqvae_tpu.utils.torch_convert import convert_vqvae_state_dict
from vqvae_tpu_torch.models import quantizers as tq
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.ops.vq import nearest_codes
from vqvae_tpu_torch.utils.convert import convert_vqvae_variables

torch.set_num_threads(1)


def _config(channels=32, num_res_blocks=1, multipliers=(1, 2), n=32, d=8):
    return parse_config({
        "image_size": 16,
        "autoencoder": {"channels": channels, "num_res_blocks": num_res_blocks,
                        "channel_multipliers": list(multipliers)},
        "quantizer": {"type": "standard", "num_embeddings": n, "embedding_dim": d,
                      "params": {"commitment_cost": 0.25}},
    })


CFG = _config()
NRB, LEVELS = 1, 2


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax variables, port model) with the same numpy weights."""
    jmodel = JaxVQVAE.from_config(CFG)
    variables = numpy_params(
        jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))), seed=21)
    tmodel = VQVAE.from_config(CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    tmodel.load_state_dict(convert_vqvae_variables(variables, NRB, LEVELS), strict=True)
    return jmodel, variables, tmodel


def _images(seed=22, b=4):
    return np.random.RandomState(seed).uniform(0, 1, (b, 16, 16, 3)).astype(np.float32)


@pytest.mark.parametrize("as_uint8", [False, True])
def test_get_tokens_exact(pair, as_uint8):
    jmodel, variables, tmodel = pair
    images = _images()
    if as_uint8:
        images = (images * 255).astype(np.uint8)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(images), method="get_tokens"))
    before = nearest_codes.launches
    got = tmodel.get_tokens(torch.from_numpy(images))
    assert nearest_codes.launches == before  # CPU tensors launch no kernel
    assert got.dtype == torch.int32 and got.shape == (4, 16)
    # the seed puts no latent on a near-tie, so the two argmins agree exactly
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 8  # a spread of codes, not one winner


def test_reconstruct_matches(pair):
    jmodel, variables, tmodel = pair
    images = _images(23)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(images), method="reconstruct"))
    got = tmodel.reconstruct(torch.from_numpy(images)).numpy()
    assert got.shape == (4, 16, 16, 3) and got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_reconstruct_from_tokens_matches(pair):
    jmodel, variables, tmodel = pair
    images = _images(24)
    tokens = np.array(jmodel.apply(variables, jnp.asarray(images), method="get_tokens"))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(tokens),
                                   method="reconstruct_from_tokens"))
    got = tmodel.reconstruct_from_tokens(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # decoding a batch's own tokens is its reconstruction
    recon = tmodel.reconstruct(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, recon, rtol=0, atol=1e-4)


def test_quantize_matches(pair):
    jmodel, variables, tmodel = pair
    images = _images(25)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(images), method="quantize"))
    got = tmodel.quantize(torch.from_numpy(images)).numpy()
    assert got.shape == (4, 16, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches(pair, masked):
    jmodel, variables, tmodel = pair
    x = _images(26) * 2 - 1
    mask = np.array([True, False, True, True]) if masked else None
    recon_j, q_loss_j, codes_j = jmodel.apply(
        variables, jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        recon, q_loss, codes = tmodel(torch.from_numpy(x),
                                      mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(q_loss.item(), float(q_loss_j), rtol=1e-4)
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), rtol=0, atol=1e-4)


def test_straight_through_gradients_reach_encoder(pair):
    _, _, tmodel = pair
    x = torch.from_numpy(_images(27) * 2 - 1)
    recon, q_loss, _ = tmodel(x)
    ((recon - x) ** 2).mean().add(q_loss).backward()
    assert tmodel.encoder.conv_in.weight.grad.abs().sum() > 0
    assert tmodel.quantizer.codebook.weight.grad.abs().sum() > 0
    tmodel.zero_grad(set_to_none=True)


def test_encode_decode_match(pair):
    jmodel, variables, tmodel = pair
    x = _images(28) * 2 - 1
    z_j = jmodel.apply(variables, jnp.asarray(x), method="encode")
    z = tmodel.encode(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(z, np.asarray(z_j), rtol=1e-4, atol=1e-5)
    y_j = jmodel.apply(variables, z_j, method="decode")
    y = tmodel.decode(torch.from_numpy(np.array(z_j))).detach().numpy()
    np.testing.assert_allclose(y, np.asarray(y_j), rtol=0, atol=1e-4)


@pytest.mark.parametrize("num_res_blocks,multipliers", [(1, (1, 2)), (2, (1, 2, 2, 4))])
def test_weights_round_trip(num_res_blocks, multipliers):
    """port state_dict -> torch_convert -> JAX variables -> convert -> same."""
    cfg = _config(num_res_blocks=num_res_blocks, multipliers=multipliers)
    model = VQVAE.from_config(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    sd = model.state_dict()
    variables = convert_vqvae_state_dict({k: v.numpy() for k, v in sd.items()}, "standard",
                                         num_res_blocks, len(multipliers))
    back = convert_vqvae_variables(variables, num_res_blocks, len(multipliers))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    VQVAE.from_config(cfg, device="cpu").load_state_dict(back, strict=True)


@pytest.mark.parametrize("masked", [False, True])
def test_codebook_usage_matches(masked):
    rs = np.random.RandomState(29)
    codes = rs.randint(0, 20, (4, 16)).astype(np.int32)  # codes 20..31 unused
    mask = np.array([True, True, False, True]) if masked else None
    want = np.asarray(jq.count_code_usage(jnp.asarray(codes), 32,
                                          None if mask is None else jnp.asarray(mask)))
    got = tq.count_code_usage(torch.from_numpy(codes), 32,
                              None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for g, w in zip(tq.get_codebook_usage(got), jq.get_codebook_usage(jnp.asarray(want))):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6)
    _, perplexity, used = tq.get_codebook_usage(torch.zeros(32, dtype=torch.int32))
    assert perplexity.item() == 1.0 and used.item() == 0.0

