"""The taming-transformers VQGAN layout of the port (``layout: taming``;
``models/autoencoder.py``'s ``TamingEncoder`` / ``TamingDecoder``) against
the benchmark's plain reference of it (``benchmark/reference/taming.py``),
on the CPU at the reference's tiny size with the benchmark's seeded random
weights: the halves, ``forward``, ``get_tokens`` and
``reconstruct_from_tokens`` in float32 and in bfloat16; the published
configuration's latent side and its module tree at the published widths
(on the meta device); and the reference's own GroupNorm and attention
against torch's."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from benchmark import inputs
from benchmark.reference import numerics, taming
from benchmark.reference.train import build
from benchmark.runtime import load_weights, weight_specs
from vqvae_tpu_torch.config import load_config, parse_config
from vqvae_tpu_torch.models.autoencoder import AttnBlock, GroupNorm
from vqvae_tpu_torch.models.vqvae import VQVAE

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
YAML = ROOT / "example_confs" / "taming_vqgan_f16.yaml"
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "taming_vqgan_f16.json").read_text())
MODEL_KEYS = ("image_size", "autoencoder", "quantizer")
SEED = 2 ** 31 + 41
BATCH = 3


def sides(dtype=torch.float32):
    """(tiny config, port model in ``dtype``, reference model), both with the
    benchmark's weights for ``SEED``."""
    cfg = taming.tiny(CONFIG)
    weights = inputs.make_weights(weight_specs(cfg), cfg, SEED, "cpu")
    port = VQVAE.from_config(parse_config({k: cfg[k] for k in MODEL_KEYS}), dtype=dtype,
                             device="cpu")
    load_weights({"model": port}, weights)
    return cfg, port, build(cfg, weights, "cpu")["model"]


def images(cfg, n=BATCH):
    """Normalized NHWC images in (-1, 1)."""
    return inputs.images(SEED, 0, n, cfg["image_size"], "cpu").float() / 127.5 - 1.0


def close(got, want, rtol):
    """|got - want| within ``rtol`` of the reference's largest magnitude."""
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=rtol * float(want.abs().max()))


# float32: the two sides differ only in the order of their sums (cuDNN-free
# CPU convs either way; attention through SDPA against two matmuls), a few
# float32 ulps of the output's scale. bfloat16: every conv, the attention and
# each GroupNorm's output round to 8 mantissa bits (2^-8 = 0.4%) on the
# port's side; over the tiny model's dozen layers that compounds to a few
# percent of the output's scale, so 4%.
RTOL = {torch.float32: 1e-5, torch.bfloat16: 4e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_halves_forward_and_decoding_match_the_reference(dtype):
    cfg, port, ref = sides(dtype)
    x = images(cfg)
    tokens = inputs.tokens(SEED, 0, BATCH, taming.latent_side(cfg) ** 2,
                           cfg["quantizer"]["num_embeddings"], "cpu")
    with torch.no_grad(), numerics.mode("fp32"):
        z_ref = ref.encoder(x.permute(0, 3, 1, 2))
        close(port.encoder(x.permute(0, 3, 1, 2)), z_ref, RTOL[dtype])
        close(port.decoder(z_ref), ref.decoder(z_ref), RTOL[dtype])
        want = ref.decode_tokens(tokens)
        close(port.reconstruct_from_tokens(tokens), want, RTOL[dtype])
        if dtype == torch.float32:
            got, want_fwd = port(x), ref(x)
            close(got[0], want_fwd[0], RTOL[dtype])
            close(got[1], want_fwd[1], RTOL[dtype])
            assert torch.equal(got[2].long(), want_fwd[2])


def test_get_tokens_equal_the_references_nearest_codes():
    cfg, port, ref = sides()
    x = images(cfg, 4)
    with torch.no_grad(), numerics.mode("fp32"):
        want = ref.quantizer.codes(ref.encoder(x.permute(0, 3, 1, 2)))
    got = port.get_tokens(x * 0.5 + 0.5)
    assert got.shape == (4, taming.latent_side(cfg) ** 2)
    assert torch.equal(got.long(), want)


def test_latent_side_is_16_at_the_published_config():
    cfg = load_config(str(YAML))
    assert cfg.autoencoder.layout == "taming" and cfg.autoencoder.compression == 16
    assert cfg.latent_size == 16 == taming.latent_side(CONFIG)


def test_published_widths_give_the_references_leaves_and_attention_blocks():
    cfg = load_config(str(YAML))
    with torch.device("meta"):
        port = VQVAE.from_config(cfg, device="meta")
        ref = taming.VQVAE(CONFIG)
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert got == want
    assert got["quantizer.codebook.weight"] == (16384, 256)
    assert got["encoder.quant_conv.weight"] == (256, 256, 1, 1)
    assert got["decoder.mid.attn_1.q.weight"] == (512, 512, 1, 1)
    assert {k for k in got if "nin_shortcut" in k} >= {"encoder.down.2.block.0.nin_shortcut.weight",
                                                       "decoder.up.3.block.0.nin_shortcut.bias"}
    for half, count in (("encoder", 3), ("decoder", 4)):
        assert sum(isinstance(m, AttnBlock) for m in getattr(port, half).modules()) == count
        assert sum(isinstance(m, taming.AttnBlock)
                   for m in getattr(ref, half).modules()) == count


def test_the_references_group_norm_is_torchs():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 64, 5, 7, generator=g) * 3 + 1
    mine = taming.GroupNorm(64)
    with torch.no_grad():
        mine.weight.uniform_(0.5, 1.5, generator=g)
        mine.bias.uniform_(-0.5, 0.5, generator=g)
    torch_gn = torch.nn.GroupNorm(32, 64, eps=1e-6)
    torch_gn.load_state_dict({"weight": mine.weight.flatten(), "bias": mine.bias.flatten()})
    port = GroupNorm(64, unbiased=False)
    port.load_state_dict(mine.state_dict())
    with torch.no_grad():
        want = torch_gn(x)
        close(mine(x), want, 1e-6)
        close(port(x), want, 1e-6)


def test_the_references_attention_is_torchs_sdpa():
    """The reference's ``AttnBlock`` in float32 against the same block in
    float64 with ``nn.GroupNorm`` and ``F.scaled_dot_product_attention``
    (one head of C channels, scale C^-1/2)."""
    g = torch.Generator().manual_seed(4)
    c = 64
    block = taming.AttnBlock(c)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
        block.norm.weight.add_(1.0)
    x = torch.randn(2, c, 4, 6, generator=g)
    with torch.no_grad(), numerics.mode("fp32"):
        got = block(x)
    xd = x.double()
    gn = torch.nn.GroupNorm(32, c, eps=1e-6).double()
    gn.load_state_dict({"weight": block.norm.weight.flatten().double(),
                        "bias": block.norm.bias.flatten().double()})

    def conv(m, t):
        return F.conv2d(t, m.weight.double(), m.bias.double())

    with torch.no_grad():
        h = gn(xd)
        rows = [conv(m, h).flatten(2).transpose(1, 2)[:, None] for m in (block.q, block.k, block.v)]
        out = F.scaled_dot_product_attention(*rows)[:, 0].transpose(1, 2).reshape(xd.shape)
        want = xd + conv(block.proj_out, out)
    close(got, want, 1e-5)


def test_height_sharding_refuses_the_layout():
    """``parallel/spatial.py`` splits 'same' 3x3 convs by rows; the taming
    layout's padded stride-2 downsampling conv is not one, and attention
    would need every row: the split is refused, and nothing is left
    changed."""
    from vqvae_tpu_torch.parallel.spatial import sharded
    _, port, _ = sides()
    before = {k: (m.padding, len(m._forward_pre_hooks)) for k, m in port.named_modules()
              if isinstance(m, torch.nn.Conv2d)}
    with pytest.raises(ValueError, match="3x3 'same' convolutions"):
        with sharded(port, shards=None):
            pass
    assert before == {k: (m.padding, len(m._forward_pre_hooks)) for k, m in port.named_modules()
                      if isinstance(m, torch.nn.Conv2d)}


def test_remat_changes_no_value_and_no_gradient():
    """``remat=True`` checkpoints every residual and attention block in
    training: the loss and every leaf's gradient equal those of the plain
    forward, bit for bit, and the leaves' names do not change."""
    cfg = taming.tiny(CONFIG)
    weights = inputs.make_weights(weight_specs(cfg), cfg, SEED, "cpu")
    x = images(cfg)
    grads = []
    for remat in (False, True):
        model = VQVAE.from_config(parse_config({k: cfg[k] for k in MODEL_KEYS}), device="cpu",
                                  remat=remat)
        load_weights({"model": model}, weights)
        recon, q_loss, _ = model(x)
        ((recon - x).square().mean() + q_loss).backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    assert all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])
