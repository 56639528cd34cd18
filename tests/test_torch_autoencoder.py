"""Autoencoder modules of the PyTorch port against the flax modules, at fp32
on the CPU. Weights are drawn with numpy, set on the JAX side and copied
through ``vqvae_tpu_torch.utils.convert``.

Tolerance rtol 1e-4 / atol 1e-5, as in test_autoencoder_parity: the JAX
encoder folds its pools into stride-2 convs and its upsamples into
lhs-dilated convs, which reorders the fp32 sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vqvae_tpu.models import autoencoder as jae
from vqvae_tpu_torch.models import autoencoder as tae
from vqvae_tpu_torch.utils import convert

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def numpy_params(variables, seed):
    """Same tree, every leaf drawn from numpy: conv kernels U(+-1/sqrt(fan_in)),
    GroupNorm scales near 1, biases and codebooks gaussian."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(shape[:3]))
            value = rs.uniform(-bound, bound, shape)
        elif name == "scale":
            value = 1.0 + 0.2 * rs.randn(*shape)
        elif name == "codebook":
            value = 0.5 * rs.randn(*shape)
        else:
            value = 0.1 * rs.randn(*shape)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(variables))


def _jax_apply(module, x_nhwc, seed):
    variables = numpy_params(module.init(jax.random.PRNGKey(0), jnp.asarray(x_nhwc)), seed)
    return variables["params"], np.asarray(module.apply(variables, jnp.asarray(x_nhwc)))


def _torch_apply(module, state, x_nhwc):
    module.load_state_dict(state, strict=True)
    with torch.no_grad():
        y = module(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous())
    return y.permute(0, 2, 3, 1).numpy()


def _inputs(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_groupnorm_matches_flax():
    x = _inputs(1, (2, 8, 8, 64))
    params, want = _jax_apply(jae.GroupNorm(), x, seed=2)
    got = _torch_apply(tae.GroupNorm(64), convert.groupnorm_state(params, ""), x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_groupnorm_uses_unbiased_variance():
    x = torch.from_numpy(_inputs(3, (2, 64, 4, 4)))
    got = tae.GroupNorm(64)(x).detach()
    xg = x.reshape(2, 32, -1)
    want = (xg - xg.mean(-1, keepdim=True)) / torch.sqrt(
        xg.var(-1, unbiased=True, keepdim=True) + 1e-6)
    torch.testing.assert_close(got, want.reshape(x.shape), rtol=RTOL, atol=ATOL)
    biased = F.group_norm(x, 32, eps=1e-6)
    assert (got - biased).abs().max() > 1e-3


@pytest.mark.parametrize("in_ch,out_ch,fold_pool", [
    (32, 32, False),   # no shortcut
    (32, 64, False),   # 1x1 shortcut
    (32, 64, True),    # + trailing Downsample, against the folded JAX block
])
def test_resblock_matches_flax(in_ch, out_ch, fold_pool):
    x = _inputs(4, (2, 8, 8, in_ch))
    params, want = _jax_apply(jae.ResBlock(out_ch, fold_pool=fold_pool), x, seed=5)
    block = tae.ResBlock(in_ch, out_ch)
    if fold_pool:
        module, prefix = torch.nn.Sequential(block, tae.Downsample()), "0"
    else:
        module, prefix = block, ""
    assert (block.conv_shortcut is None) == (in_ch == out_ch)
    got = _torch_apply(module, convert.resblock_state(params, prefix), x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_upsample_matches_flax():
    x = _inputs(6, (2, 4, 4, 32))
    params, want = _jax_apply(jae.Upsample(32), x, seed=7)
    got = _torch_apply(tae.Upsample(32),
                       convert.conv_state(params["conv"]["Conv_0"], "conv"), x)
    assert got.shape == (2, 8, 8, 32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


CH, NRB, MULT, EDIM = 32, 1, (1, 2), 8


def test_encoder_matches_flax():
    x = _inputs(8, (2, 16, 16, 3))
    enc = jae.Encoder(channels=CH, num_res_blocks=NRB, channel_multipliers=MULT,
                      embedding_dim=EDIM)
    params, want = _jax_apply(enc, x, seed=9)
    got = _torch_apply(tae.Encoder(CH, NRB, MULT, EDIM),
                       convert.convert_encoder(params, NRB, len(MULT), prefix=""), x)
    assert got.shape == (2, 4, 4, EDIM) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_decoder_matches_flax():
    z = _inputs(10, (2, 4, 4, EDIM))
    dec = jae.Decoder(channels=CH, num_res_blocks=NRB, channel_multipliers=MULT,
                      embedding_dim=EDIM)
    params, want = _jax_apply(dec, z, seed=11)
    got = _torch_apply(tae.Decoder(CH, NRB, MULT, EDIM),
                       convert.convert_decoder(params, NRB, len(MULT), prefix=""), z)
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_init_is_seeded_and_torch_default():
    a = tae.Encoder(CH, NRB, MULT, EDIM, generator=torch.Generator().manual_seed(3))
    b = tae.Encoder(CH, NRB, MULT, EDIM, generator=torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    w = a.blocks[0].conv1.weight
    bound = 1.0 / np.sqrt(w.shape[1] * 9)
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert torch.equal(a.norm.weight, torch.ones(1, CH * MULT[-1], 1, 1))


def test_bf16_compute_keeps_fp32_params_and_stats():
    enc = tae.Encoder(CH, NRB, MULT, EDIM, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in enc.parameters())
    x = torch.from_numpy(_inputs(12, (1, 3, 16, 16)))
    with torch.no_grad():
        y = enc(x)
        h = enc.conv_in(x)
        assert h.dtype == torch.bfloat16
        assert enc.blocks[0].norm1(h).dtype == torch.bfloat16
    assert y.dtype == torch.float32 and torch.isfinite(y).all()
