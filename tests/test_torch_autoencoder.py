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


# ---------------------------------------------------------------- the layout rule
#
# Channels-last activations (``tae.layout``): a half in bf16 whose GroupNorm
# takes the kernel (autograd not recording, no sharded call) keeps them from
# its entry to its last conv; every other call stays contiguous NCHW.

LAYOUTS = ("serezd", "taming")


def _tiny_model(layout: str, dtype=torch.bfloat16):
    import json
    from pathlib import Path

    from benchmark.reference import taming
    from vqvae_tpu_torch.config import parse_config
    from vqvae_tpu_torch.models.vqvae import VQVAE
    if layout == "taming":
        path = Path(__file__).resolve().parent.parent / "benchmark/configs/taming_vqgan_f16.json"
        raw = taming.tiny(json.loads(path.read_text()))
    else:
        raw = {"image_size": 16,
               "autoencoder": {"channels": 32, "num_res_blocks": 1, "channel_multipliers": [1, 2]},
               "quantizer": {"type": "standard", "num_embeddings": 16, "embedding_dim": 8,
                             "params": {"commitment_cost": 0.25},
                             "reinit_every_n_epochs": None}}
    cfg = parse_config({k: raw[k] for k in ("image_size", "autoencoder", "quantizer")})
    return VQVAE.from_config(cfg, dtype=dtype, device="cpu",
                             generator=torch.Generator().manual_seed(0))


def _channels_last(t: torch.Tensor) -> bool:
    return t.is_contiguous(memory_format=torch.channels_last) and not t.is_contiguous()


def _block_outputs(part, run) -> list:
    """(block type, channels-last, contiguous NCHW) of every residual block's,
    attention block's and upsample's output while ``run()`` runs."""
    seen = []

    def hook(module, args, out):
        seen.append((type(module).__name__, _channels_last(out), out.is_contiguous()))

    handles = [m.register_forward_hook(hook) for m in part.modules()
               if isinstance(m, (tae.ResBlock, tae.AttnBlock, tae.Upsample))]
    try:
        run()
    finally:
        for handle in handles:
            handle.remove()
    return seen


def _half_input(model, half: str, dtype=torch.float32):
    gen = torch.Generator().manual_seed(1)
    if half == "encoder":
        return torch.randn(2, 3, 16, 16, generator=gen, dtype=dtype)
    first = getattr(model.decoder, "post_quant_conv", model.decoder.conv_in)
    return torch.randn(2, first.in_channels, 8, 8, generator=gen, dtype=dtype)


@pytest.mark.parametrize("half", ["encoder", "decoder"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_bf16_inference_keeps_activations_channels_last(layout, half):
    model = _tiny_model(layout)
    part, x = getattr(model, half), _half_input(model, half)
    with torch.no_grad():
        seen = _block_outputs(part, lambda: part(x))
    kinds = {kind for kind, _, _ in seen}
    want = {"ResBlock"} | ({"AttnBlock"} if layout == "taming" else set()) | (
        {"Upsample"} if half == "decoder" else set())
    assert kinds == want
    assert all(cl for _, cl, _ in seen), seen


@pytest.mark.parametrize("layout", LAYOUTS)
def test_channels_last_decoding_equals_the_nchw_forward(layout):
    """The decoder under ``no_grad`` (channels-last) against the same module
    with autograd on (contiguous NCHW throughout) in bf16: equal within
    bf16's rounding of the two convolution layouts."""
    model = _tiny_model(layout)
    x = _half_input(model, "decoder")
    with torch.no_grad():
        got = model.decoder(x)
    seen = []
    want = _block_outputs(model.decoder, lambda: seen.append(model.decoder(x)))
    assert want and all(nchw and not cl for _, cl, nchw in want), want
    torch.testing.assert_close(got, seen[0].detach(), rtol=0.05, atol=0.05)
    assert got.is_contiguous(memory_format=torch.channels_last)


def test_other_calls_stay_contiguous_nchw():
    """fp32, bf16 under autograd and a sharded bf16 call keep contiguous
    NCHW in both halves."""
    from vqvae_tpu_torch.parallel import spatial

    class _OneShard:
        """A height-sharded call's ``shards`` on one process."""
        rank, size = 0, 1

        @staticmethod
        def sum(t):
            return t

        @staticmethod
        def halo(t):
            zero = torch.zeros_like(t[:, :, :1])
            return torch.cat([zero, t, zero], 2)

    for layout in LAYOUTS:
        fp32 = _tiny_model(layout, torch.float32)
        bf16 = _tiny_model(layout)
        for half in ("encoder", "decoder"):
            x = _half_input(fp32, half)
            with torch.no_grad():
                seen = _block_outputs(getattr(fp32, half), lambda: getattr(fp32, half)(x))
            seen += _block_outputs(getattr(bf16, half), lambda: getattr(bf16, half)(x))
            assert seen and all(nchw and not cl for _, cl, nchw in seen), (layout, half, seen)
    model = _tiny_model("serezd")
    with torch.no_grad(), spatial.sharded(model, _OneShard()):
        for half in ("encoder", "decoder"):
            x = _half_input(model, half)
            seen = _block_outputs(getattr(model, half), lambda: getattr(model, half)(x))
            assert seen and all(nchw and not cl for _, cl, nchw in seen), (half, seen)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tokenizer_api_returns_contiguous_nhwc(layout):
    model = _tiny_model(layout)
    side = 8 if layout == "taming" else 4   # 16^2 images: two levels, or one, halve them
    tokens = torch.randint(0, 16, (2, side * side), generator=torch.Generator().manual_seed(0))
    images = model.reconstruct_from_tokens(tokens)
    assert images.shape == (2, 16, 16, 3) and images.is_contiguous()
    recon = model.reconstruct(torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(1)))
    assert recon.shape == (2, 16, 16, 3) and recon.is_contiguous()
