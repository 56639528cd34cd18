"""MoVQ, the taming layout with ``norm_type: spatial`` (``models/autoencoder.py``'s
``SpatialNorm`` in every normalization of ``TamingDecoder``), against the
benchmark's plain reference of it (``benchmark/reference/movq.py``), on the
CPU at the reference's tiny size: the decoder, ``forward``,
``reconstruct_from_tokens`` and ``get_tokens`` in float32 and bfloat16, with
the benchmark's weights and with the port's own seeded init; the
latent-resolution modulation against the published full-size form; the
published configuration's latent side, module tree and SpatialNorm calls
(on the meta device); the taming configuration's construction as it was
before MoVQ.

On the card (``cuda``), at the published size: ``gn_silu``'s NHWC two-pass
form at the decoder's largest shapes against its plain version and its byte
bound, and ``get_tokens`` of 64 images of 512^2 in fp32 against the plain
reference's nearest codes:

    python -m pytest tests/test_torch_movq.py -m cuda -s --noconftest
"""

from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from benchmark import inputs
from benchmark.reference import movq, numerics, taming
from benchmark.reference.train import build
from benchmark.runtime import load_weights, weight_specs
from vqvae_tpu_torch.config import load_config, parse_config
from vqvae_tpu_torch.models.autoencoder import AttnBlock, SpatialNorm, spatial_norm
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.ops.gn_silu import channels_last

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
YAML = ROOT / "example_confs" / "kandinsky22_movq.yaml"
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "kandinsky22_movq.json").read_text())
TAMING = json.loads((ROOT / "benchmark" / "configs" / "taming_vqgan_f16.json").read_text())
MODEL_KEYS = ("image_size", "autoencoder", "quantizer")
SEED = 2 ** 31 + 43
BATCH = 3


def model_config(cfg: dict):
    return parse_config({k: cfg[k] for k in MODEL_KEYS})


def sides(dtype=torch.float32, weights="benchmark"):
    """(tiny config, port model in ``dtype``, reference model) with one set
    of weights: the benchmark's for ``SEED``, or the port's own init from a
    generator seeded with ``SEED`` (its 1x1 modulation kernels U(+-1/2),
    not near 1 as the benchmark's GroupNorm-scale rule draws them)."""
    cfg = movq.tiny(CONFIG)
    if weights == "benchmark":
        drawn = inputs.make_weights(weight_specs(cfg), cfg, SEED, "cpu")
        port = VQVAE.from_config(model_config(cfg), dtype=dtype, device="cpu")
        load_weights({"model": port}, drawn)
        return cfg, port, build(cfg, drawn, "cpu")["model"]
    port = VQVAE.from_config(model_config(cfg), dtype=dtype, device="cpu",
                             generator=torch.Generator().manual_seed(SEED))
    ref = movq.VQVAE(cfg)
    ref.load_state_dict(port.state_dict(), strict=True)
    return cfg, port, ref


def images(cfg, n=BATCH):
    """Normalized NHWC images in (-1, 1)."""
    return inputs.images(SEED, 0, n, cfg["image_size"], "cpu").float() / 127.5 - 1.0


def close(got, want, rtol):
    """|got - want| within ``rtol`` of the reference's largest magnitude."""
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=rtol * float(want.abs().max()))


# float32: the two sides differ in the order of their sums and in where the
# modulation's 1x1 convs run (latent against full resolution), a few float32
# ulps of the output's scale. bfloat16: every conv, the attention, each
# GroupNorm's output and each modulation round to 8 mantissa bits (2^-8 =
# 0.4%) on the port's side; over the tiny decoder's dozen layers that
# compounds to a few percent of the output's scale, so 4%, as for taming.
RTOL = {torch.float32: 1e-5, torch.bfloat16: 4e-2}


@pytest.mark.parametrize("weights", ["benchmark", "own"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_decoding_and_forward_match_the_reference(dtype, weights):
    cfg, port, ref = sides(dtype, weights)
    x = images(cfg)
    tokens = inputs.tokens(SEED, 0, BATCH, movq.latent_side(cfg) ** 2,
                           cfg["quantizer"]["num_embeddings"], "cpu")
    with torch.no_grad(), numerics.mode("fp32"):
        z_ref = ref.encoder(x.permute(0, 3, 1, 2))
        close(port.encoder(x.permute(0, 3, 1, 2)), z_ref, RTOL[dtype])
        close(port.decoder(z_ref), ref.decoder(z_ref), RTOL[dtype])
        close(port.reconstruct_from_tokens(tokens), ref.decode_tokens(tokens), RTOL[dtype])
        if dtype == torch.float32:
            got, want = port(x), ref(x)
            close(got[0], want[0], RTOL[dtype])
            close(got[1], want[1], RTOL[dtype])
            assert torch.equal(got[2].long(), want[2])


@pytest.mark.parametrize("act", [False, True], ids=["norm", "norm_silu"])
@pytest.mark.parametrize("dtype,fmt", [(torch.float32, torch.contiguous_format),
                                       (torch.float32, torch.channels_last),
                                       (torch.bfloat16, torch.channels_last)],
                         ids=["fp32", "fp32-channels_last", "bf16-channels_last"])
def test_latent_resolution_modulation_is_the_full_size_form(dtype, fmt, act):
    """``spatial_norm`` (1x1 convs on zq at 4^2, read by a broadcast over
    16^2) against GN(f) * conv_y(up(zq)) + conv_b(up(zq)) with up the
    full-size nearest interpolation, on a zq that differs at every latent
    pixel and in every channel; the result keeps f's layout. Inference
    (the kernel's dispatch) and autograd (the plain form) alike."""
    g = torch.Generator().manual_seed(7)
    norm = SpatialNorm(64, 4, dtype=dtype, generator=g)
    with torch.no_grad():
        norm.norm_layer.weight.uniform_(0.5, 1.5, generator=g)
        norm.norm_layer.bias.uniform_(-0.5, 0.5, generator=g)
    f = (torch.randn(2, 64, 16, 16, generator=g) * 2 + 0.5).to(dtype, memory_format=fmt)
    zq = torch.randn(2, 4, 4, 4, generator=g).to(dtype, memory_format=fmt)
    assert torch.unique(zq.permute(0, 2, 3, 1).reshape(-1, 4), dim=0).shape[0] == 32
    up = F.interpolate(zq.float(), size=(16, 16), mode="nearest")
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            got = spatial_norm(norm, f, zq, act)
            want = (norm.norm_layer(f).float() * F.conv2d(up, norm.conv_y.weight, norm.conv_y.bias)
                    + F.conv2d(up, norm.conv_b.weight, norm.conv_b.bias))
            if act:
                want = F.silu(want)
        assert got.dtype == dtype and channels_last(got) == (fmt == torch.channels_last)
        # bf16: the port rounds the scale and shift and the result (one bf16
        # ulp each, 2^-8 of the result's scale)
        close(got.detach(), want.detach(), 1e-6 if dtype == torch.float32 else 2 ** -7)


def test_get_tokens_equal_the_references_nearest_codes():
    cfg, port, ref = sides()
    x = images(cfg, 4)
    with torch.no_grad(), numerics.mode("fp32"):
        want = ref.quantizer.codes(ref.encoder(x.permute(0, 3, 1, 2)))
    got = port.get_tokens(x * 0.5 + 0.5)
    assert got.shape == (4, movq.latent_side(cfg) ** 2)
    assert torch.equal(got.long(), want)


def test_latent_side_is_64_at_the_published_config():
    cfg = load_config(str(YAML))
    assert cfg.autoencoder.norm_type == "spatial" and cfg.autoencoder.compression == 8
    assert cfg.latent_size == 64 == movq.latent_side(CONFIG)


def test_published_widths_give_the_references_leaves_and_33_spatial_norms():
    """On the meta device: the port's and the reference's leaves, names and
    shapes; 33 SpatialNorms and 4 attention blocks in the decoder, 3
    attention blocks and no SpatialNorm in the encoder; one decode of the
    published config makes 33 ``spatial_norm`` calls (autograd records on
    the meta device, so the plain form runs)."""
    cfg = load_config(str(YAML))
    with torch.device("meta"):
        port = VQVAE.from_config(cfg, device="meta")
        ref = movq.VQVAE(CONFIG)
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert got["quantizer.codebook.weight"] == (16384, 4)
    assert got["encoder.quant_conv.weight"] == (4, 4, 1, 1)
    assert got["decoder.post_quant_conv.weight"] == (4, 4, 1, 1)
    assert got["decoder.mid.attn_1.norm.conv_y.weight"] == (512, 4, 1, 1)
    assert got["decoder.up.0.block.0.norm1.conv_b.bias"] == (256,)
    assert got["decoder.norm_out.norm_layer.weight"] == (1, 128, 1, 1)
    assert "encoder.norm_out.weight" in got and "decoder.norm_out.weight" not in got
    for half, norms, attn in (("encoder", 0, 3), ("decoder", 33, 4)):
        modules = list(getattr(port, half).modules())
        assert sum(isinstance(m, SpatialNorm) for m in modules) == norms
        assert sum(isinstance(m, AttnBlock) for m in modules) == attn
        assert sum(isinstance(m, movq.AttnBlock) for m in getattr(ref, half).modules()) == \
            (attn if half == "decoder" else 0)
    calls = spatial_norm.calls
    assert port.decoder(torch.empty(1, 4, 64, 64, device="meta")).shape == (1, 3, 512, 512)
    assert spatial_norm.calls - calls == 33


def test_spatial_norm_type_is_refused_outside_the_taming_layout():
    raw = {k: CONFIG[k] for k in MODEL_KEYS}
    with pytest.raises(ValueError, match="needs layout: taming"):
        parse_config(dict(raw, autoencoder=dict(raw["autoencoder"], layout="serezd")))
    with pytest.raises(ValueError, match="unknown norm_type"):
        parse_config(dict(raw, autoencoder=dict(raw["autoencoder"], norm_type="batch")))


def _digest(tensors: dict) -> str:
    h = hashlib.sha256()
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous()
        h.update(f"{name}:{tuple(t.shape)}:{t.dtype};".encode())
        h.update(t.float().numpy().tobytes())
    return h.hexdigest()


# the taming configuration as the port built and decoded it before MoVQ
# (``norm_type: group``): the published widths' state_dict drawn from seed
# 5, and the tiny copy's (one thread: the float32 convs' sums in one order)
TAMING_DIGESTS = {
    "state": "ec115e587e1a2f0d6a6b7d54b6c0353742095b3c6d6e95fdad9511995bfe4ce2",
    "tiny_state": "8933982f02a8657ff93bc5ccd2a41a73c7622d6b81249dc815765f99626ef5ee",
    torch.float32: "de157a1492d6474a6807e7b2df6f6d7d16c4c566235139742cfc965ed7566ae4",
    torch.bfloat16: "e4db79174c5bf9cc2c40a998a595739be8de31388ee4c978e6ab0e2b1e0b2b73",
}


def test_taming_construction_and_decoding_are_unchanged():
    full = VQVAE.from_config(load_config(str(ROOT / "example_confs" / "taming_vqgan_f16.yaml")),
                             device="cpu", generator=torch.Generator().manual_seed(5))
    assert full.decoder.spatial is False
    assert _digest(full.state_dict()) == TAMING_DIGESTS["state"]
    del full
    cfg = taming.tiny(TAMING)
    tokens = inputs.tokens(2 ** 31 + 41, 0, 3, 64, 16, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for dtype in (torch.float32, torch.bfloat16):
            model = VQVAE.from_config(model_config(cfg), dtype=dtype, device="cpu",
                                      generator=torch.Generator().manual_seed(5))
            assert _digest(model.state_dict()) == TAMING_DIGESTS["tiny_state"]
            calls = spatial_norm.calls
            decoded = model.reconstruct_from_tokens(tokens)
            assert spatial_norm.calls == calls
            assert _digest({"x": decoded}) == TAMING_DIGESTS[dtype], dtype
    finally:
        torch.set_num_threads(threads)


# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ms(fn, reps: int) -> float:
    """Mean CUDA-event ms of ``reps`` calls after two warm-up calls."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 256, 512, 512), (8, 128, 512, 512), (8, 256, 256, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gn_silu_two_pass_form_at_movq_shapes_on_card(shape):
    """The decoder's largest GroupNorm inputs at batch 8, bf16 channels-last:
    the NHWC two-pass form (two launches a call) within ``kernel_error``'s
    limit, and its time against one read and one write at 3.35 TB/s."""
    from gn_silu_check import kernel_error

    from vqvae_tpu_torch.ops import gn_silu as gs
    from vqvae_tpu_torch.ops import gn_silu_cuda as gsc
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(11)
    x = (1.5 + 2.0 * torch.randn(shape, device=dev, generator=gen)).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    weight = 1 + 0.5 * torch.randn(1, shape[1], 1, 1, device=dev, generator=gen)
    bias = 0.5 * torch.randn(1, shape[1], 1, 1, device=dev, generator=gen)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = gsc.plan_nhwc(shape[0], 32, shape[1] // 32, shape[2] * shape[3], 2, True, sms)
    assert plan.parts > 0, plan
    launches = gs.gn_silu.launches
    norm = gsc.gn_silu_cuda(x, weight, bias, 32, 1e-6, 0, False)
    act = gsc.gn_silu_cuda(x, weight, bias, 32, 1e-6, 0, True)
    assert gs.gn_silu.launches - launches == 4
    worst = kernel_error(x, weight, bias, 32, 1e-6, 0, norm, act)
    del norm, act
    torch.cuda.empty_cache()
    ms = _ms(lambda: gsc.gn_silu_cuda(x, weight, bias, 32, 1e-6, 0, True), reps=20)
    bound_ms = 2 * x.numel() * x.element_size() / 3.35e12 * 1e3
    print(f"\ngn_silu two-pass {shape} bf16 channels-last ({plan}): worst share of the limit "
          f"{worst:.3f}; {ms:.4f} ms against the byte bound {bound_ms:.4f} ms "
          f"({bound_ms / ms:.1%}); {torch.cuda.get_device_name(dev)}")
    assert worst <= 1


@pytest.mark.cuda
def test_get_tokens_of_64_images_at_512_on_card():
    """``get_tokens`` as ``cli.tokenize_dataset`` runs it (fp32, TF32 off)
    on 64 images of 512^2, B1 at (262144, 16384, 4), with the benchmark's
    weights: ``code_gap`` against the plain reference's latents within the
    export cell's limit (3e-5), and the call's time."""
    from benchmark import compare
    from benchmark.reference.train import encode_latents
    from vqvae_tpu_torch.ops import vq
    from vqvae_tpu_torch.utils.precision import set_full_fp32
    dev = _card()
    set_full_fp32()
    seed = 2 ** 31 + 61
    weights = inputs.make_weights(weight_specs(CONFIG), CONFIG, seed, dev)
    model = VQVAE.from_config(load_config(str(YAML)), dtype=torch.float32, device=dev)
    load_weights({"model": model}, weights)
    raw = inputs.images(seed, 0, 64, 512, dev)
    x = raw.float() / 255.0
    launches = vq.nearest_codes.launches
    model.get_tokens(x)
    assert vq.nearest_codes.launches - launches == 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes = model.get_tokens(x)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    del model, x
    torch.cuda.empty_cache()
    with numerics.mode("fp32"):
        latents = encode_latents(CONFIG, weights, raw)
    gap = compare.code_gap(latents, weights["model.quantizer.codebook.weight"],
                           codes.reshape(-1))
    print(f"\nget_tokens 64 x 512^2 fp32: {seconds * 1e3:.1f} ms a call "
          f"({64 / seconds:.1f} images/s), peak {peak / 1e9:.2f} GB; {gap}; latents' std "
          f"{float(latents.std()):.4f}; {torch.cuda.get_device_name(dev)}")
    assert codes.shape == (64, 4096)
    assert gap["code_gap"] <= 3e-5, gap
