"""The plain reference (``benchmark/reference/``) against the port at a tiny
configuration on the CPU, in float32, layer by layer: encoder, decoder,
the gumbel and EMA quantizers (B2's counts, sums and buffer update), B1's
codes, LPIPS-VGG, the discriminator (``bias_act``, ``upfirdn2d``,
``conv2d_resample``), the R1 term and AdamW; then whole training steps
through the harness. Both sides get the benchmark's weights; each
configuration's reference is the one it names (``reference.of``)."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import inputs
from benchmark.reference import nets
from benchmark.reference.train import AdamW, build
from benchmark.run import HERE
from benchmark.runtime import load_weights, weight_specs
from benchmark.tests.tiny import tiny_config

SEED = 2 ** 31 + 17
CONFIGS = [c["name"] for c in
           json.loads((HERE.parent / "BENCHMARK.json").read_text())["configs"]]


def sides(name: str):
    from vqvae_tpu_torch.config import parse_config
    from vqvae_tpu_torch.models.discriminator import Discriminator
    from vqvae_tpu_torch.models.lpips import LPIPS
    from vqvae_tpu_torch.models.vqvae import VQVAE

    cfg = tiny_config(name)
    weights = inputs.make_weights(weight_specs(cfg), cfg, SEED, "cpu")
    model_cfg = parse_config({k: cfg[k] for k in
                              ("image_size", "autoencoder", "quantizer", "loss", "training")
                              if k in cfg})
    port = {"model": VQVAE.from_config(model_cfg, device="cpu")}
    if cfg.get("loss"):
        port["disc"] = Discriminator(cfg["image_size"], device="cpu", **cfg["discriminator"])
        port["lpips"] = LPIPS("vgg", device="cpu")
    load_weights(port, weights)
    return cfg, weights, port, build(cfg, weights, "cpu")


def images(cfg, n=4, index=0):
    return nets.normalize(inputs.images(SEED, index, n, cfg["image_size"], "cpu"))


def close(a, b, rtol=1e-5):
    torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=rtol * b.abs().max())


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_autoencoder_halves(name, part):
    """Each configuration of BENCHMARK.json, through its own reference."""
    cfg, _, port, ref = sides(name)
    x = images(cfg).permute(0, 3, 1, 2)
    if part == "decoder":
        with torch.no_grad():
            # the decoder takes D channels (a gumbel encoder gives N logits)
            x = port["model"].encoder(x)[:, : cfg["quantizer"]["embedding_dim"]]
    with torch.no_grad():
        close(getattr(port["model"], part)(x), getattr(ref["model"], part)(x))


def test_gumbel_quantizer():
    cfg, _, port, ref = sides("gumbel_vqgan")
    with torch.no_grad():
        z = port["model"].encoder(images(cfg).permute(0, 3, 1, 2))
        got = port["model"].quantizer(z, train=True, temp=0.5, kl_cost=0.01,
                                      generator=torch.Generator().manual_seed(3))
        want = ref["model"].quantizer(z, True, temp=0.5, kl_cost=0.01,
                                      generator=torch.Generator().manual_seed(3))
    close(got[0], want[0])
    assert torch.equal(got[1].long(), want[1].long())
    close(got[2], want[2])


def test_ema_quantizer_and_its_update():
    cfg, _, port, ref = sides("ema_vqvae")
    with torch.no_grad():
        z = port["model"].encoder(images(cfg).permute(0, 3, 1, 2))
        got = port["model"].quantizer(z, train=True)
        want = ref["model"].quantizer(z, True)
    close(got[0], want[0])
    assert torch.equal(got[1].long(), want[1].long())
    close(got[2], want[2])
    for key in ("codebook.weight", "ema_count", "ema_weight"):
        close(port["model"].quantizer.state_dict()[key], ref["model"].quantizer.state_dict()[key])


def test_b1_codes_on_every_row():
    from vqvae_tpu_torch.ops.vq import nearest_codes
    cfg, weights, port, ref = sides("ema_vqvae")
    with torch.no_grad():
        z = port["model"].encoder(images(cfg, 8).permute(0, 3, 1, 2))
    flat = z.permute(0, 2, 3, 1).reshape(-1, z.shape[1])
    codebook = weights["model.quantizer.codebook.weight"]
    assert torch.equal(nearest_codes(flat, codebook).long(),
                       nets.scores(flat, codebook).argmin(1))


def test_lpips_vgg():
    cfg, _, port, ref = sides("gumbel_vqgan")
    x, y = images(cfg, index=0), images(cfg, index=1)
    with torch.no_grad():
        close(port["lpips"](x, y), ref["lpips"](x, y))


@pytest.mark.parametrize("r1", [False, True])
def test_discriminator_and_r1(r1):
    """The logits, and the D's gradient of the real half (with the R1 term,
    a second-order gradient, on an R1 step)."""
    cfg, _, port, ref = sides("gumbel_vqgan")
    grads = []
    for disc in (port["disc"], ref["disc"]):
        real = images(cfg).permute(0, 3, 1, 2).requires_grad_(r1)
        logits = disc(real, fused=False) if disc is port["disc"] else disc(real)
        loss = torch.nn.functional.softplus(-logits).mean()
        if r1:
            (g,) = torch.autograd.grad(logits.sum(), real, create_graph=True)
            loss = loss + 10.0 * g.square().flatten(1).sum(1).mean()
        loss.backward()
        grads.append({k: p.grad for k, p in disc.named_parameters()})
        grads[-1]["logits"] = logits.detach()
    for key, want in grads[1].items():
        close(grads[0][key], want, rtol=1e-4)


def test_adamw_matches_torch():
    from vqvae_tpu_torch.train.optim import make_ae_optimizer
    cfg, weights, port, ref = sides("ema_vqvae")
    model = port["model"]
    torch_opt = make_ae_optimizer(model, (0.0, 0.99), 1e-8, 1e-4)
    leaves = {f"model.{k}": p for k, p in ref["model"].named_parameters()}
    ours = AdamW(leaves, nets.decay_names(ref["model"], "model."), (0.0, 0.99), 1e-8, 1e-4)
    for step in range(3):
        g = torch.Generator().manual_seed(step)
        for k, p in model.named_parameters():
            p.grad = torch.randn(p.shape, generator=g)
            leaves[f"model.{k}"].grad = p.grad.clone()
        for group in torch_opt.param_groups:
            group["lr"] = 1e-3
        torch_opt.step()
        ours.step(1e-3)
    for k, p in model.named_parameters():
        close(p.detach(), leaves[f"model.{k}"].detach())
