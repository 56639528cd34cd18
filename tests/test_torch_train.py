"""Training pieces of the PyTorch port against the JAX package on the CPU:
LR schedules (rtol 1e-6), the AdamW optimizer with its decay split over 5
steps (rtol 1e-6), the crop-resize of the augmentation (atol 1e-5) and the
augmentation's distribution; the Trainer refuses what it does not carry, and
its ``train_step`` / ``eval_step`` require ``epoch`` as the JAX Trainer's do.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_autoencoder import numpy_params
from vqvae_tpu.models import preprocess as jpre
from vqvae_tpu.models.vqvae import VQVAE as JaxVQVAE
from vqvae_tpu.train import optim as joptim
from vqvae_tpu.train import schedules as jsched
from vqvae_tpu.train.loop import Trainer as JaxTrainer
from vqvae_tpu_torch.config import parse_config
from vqvae_tpu_torch.models import preprocess as tpre
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.train import optim as toptim
from vqvae_tpu_torch.train import schedules as tsched
from vqvae_tpu_torch.train.loop import Trainer
from vqvae_tpu_torch.utils.convert import convert_vqvae_variables

torch.set_num_threads(1)

RAW = {
    "image_size": 16,
    "autoencoder": {"channels": 32, "num_res_blocks": 1, "channel_multipliers": [1, 2]},
    "quantizer": {"type": "standard", "num_embeddings": 32, "embedding_dim": 8,
                  "params": {"commitment_cost": 0.25}},
    "training": {"cumulative_bs": 8, "base_lr": 1e-3, "betas": [0.0, 0.99], "eps": 1e-8,
                 "weight_decay": 1e-4, "decay_epochs": 1, "max_epochs": 300},
}


@pytest.mark.parametrize("name,args", [
    ("linear_schedule", (2.0, 20.0, 0.5, 3.0)),
    ("cosine_schedule", (0.0, 24.0, 1e-3, 5e-4)),
    ("linear_cosine_schedule", (0.0, 30.0, 1e-3, 5e-4, 6.0)),
    ("constant_schedule", (7e-4,)),
])
def test_schedules_match_jax(name, args):
    want = getattr(jsched, name)(*args)
    got = getattr(tsched, name)(*args)
    steps = range(0, 40)
    np.testing.assert_allclose([got(i) for i in steps], [float(want(i)) for i in steps],
                               rtol=1e-6)


@pytest.mark.parametrize("warmup,decay", [(None, None), (2.0, None), (None, 3.0), (1.0, 3.0)])
def test_build_lr_schedule_matches_jax(warmup, decay):
    want = jsched.build_lr_schedule(1e-4, 10, warmup, decay)
    got = tsched.build_lr_schedule(1e-4, 10, warmup, decay)
    steps = range(0, 35)
    np.testing.assert_allclose([got(i) for i in steps], [float(want(i)) for i in steps],
                               rtol=1e-6)


def test_optimizer_matches_make_ae_optimizer():
    """5 AdamW steps on random parameters and gradients, the LR of step i set
    before it; weight decay on conv kernels only, GroupNorm (4-D here) and
    biases and the codebook without."""
    cfg = parse_config(RAW)
    t = cfg.training
    jmodel = JaxVQVAE.from_config(cfg)
    params = numpy_params(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))),
                          seed=41)["params"]
    sched = jsched.build_lr_schedule(1e-2, 5, None, 1.0)
    tx = joptim.make_ae_optimizer(sched, t.betas, t.eps, 0.05)

    model = VQVAE.from_config(cfg, device="cpu")
    model.load_state_dict(convert_vqvae_variables({"params": params}, 1, 2), strict=True)
    opt = toptim.make_ae_optimizer(model, t.betas, t.eps, 0.05)
    lr_sched = tsched.build_lr_schedule(1e-2, 5, None, 1.0)

    # the decay split is the JAX package's 4-D mask carried through the converter
    jmask = convert_vqvae_variables(
        {"params": jax.tree.map(lambda m, p: np.full(p.shape, m, np.float32),
                                joptim.decay_mask(params), params)}, 1, 2)
    mask = toptim.decay_mask(model)
    assert mask == {k: bool(v.all()) for k, v in jmask.items()}
    assert not mask["encoder.norm.weight"] and model.encoder.norm.weight.dim() == 4
    assert mask["encoder.conv_in.weight"] and not mask["quantizer.codebook.weight"]
    assert [g["weight_decay"] for g in opt.param_groups] == [0.05, 0.0]
    assert sum(len(g["params"]) for g in opt.param_groups) == len(list(model.parameters()))

    rs = np.random.RandomState(42)
    opt_state = tx.init(params)
    named = dict(model.named_parameters())
    for i in range(5):
        grads = jax.tree.map(lambda p: (rs.randn(*p.shape) * 1e-2).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        toptim.set_lr(opt, lr_sched(i))
        for k, g in convert_vqvae_variables({"params": grads}, 1, 2).items():
            named[k].grad = g
        opt.step()
    want = convert_vqvae_variables({"params": jax.device_get(params)}, 1, 2)
    # rtol 1e-6 of each tensor's scale: an entry near 0 is a difference of
    # terms of that scale, which the two AdamW orders (torch decays before the
    # Adam step, optax after) round apart
    for k, p in named.items():
        w = want[k].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("size,crop,y0,x0", [
    (16, 13, 3, 0),    # the crop that F.interpolate of the cut-out gets wrong by 0.061
    (16, 16, 0, 0),
    (16, 11, 2, 5),
    (24, 20, 4, 1),
])
def test_crop_resize_matches_jax(size, crop, y0, x0):
    img = np.random.RandomState(size + crop).rand(size, size, 3).astype(np.float32)
    want = np.asarray(jpre._crop_resize_one(jnp.asarray(img), jnp.float32(crop),
                                            jnp.float32(y0), jnp.float32(x0), size))
    f = lambda v: torch.tensor([float(v)])
    got = tpre.crop_resize(torch.from_numpy(img)[None], f(crop), f(y0), f(x0), size)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_augmentation_distribution(monkeypatch):
    """Crop sides in [floor(sqrt(0.7) H), H], starts inside the image, and
    about half of the samples flipped, as the JAX augmentation draws them."""
    b, h = 400, 16
    seen = {}
    crop_resize = tpre.crop_resize

    def record(images, crop, y0, x0, out_size):
        seen.update(crop=crop, y0=y0, x0=x0)
        seen["out"] = crop_resize(images, crop, y0, x0, out_size)
        return seen["out"]

    monkeypatch.setattr(tpre, "crop_resize", record)
    images = torch.from_numpy(np.random.RandomState(5).rand(b, h, h, 3).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    out = tpre.random_resized_crop_flip(images, h, gen)
    crop, y0, x0 = seen["crop"], seen["y0"], seen["x0"]
    assert out.shape == images.shape
    assert crop.min() >= np.floor(np.sqrt(0.7) * h) and crop.max() <= h
    assert crop.unique().numel() >= 3
    assert (y0 >= 0).all() and (y0 + crop <= h).all() and (x0 >= 0).all() and (x0 + crop <= h).all()
    flipped = torch.tensor([torch.equal(o, r.flip(1)) and not torch.equal(o, r)
                            for o, r in zip(out, seen["out"])])
    same = torch.tensor([torch.equal(o, r) for o, r in zip(out, seen["out"])])
    assert bool((flipped | same).all())
    assert 0.4 < flipped.float().mean() < 0.6
    # the draws come from the generator alone
    again = tpre.random_resized_crop_flip(images, h, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)


def test_train_preprocess_needs_a_generator():
    with pytest.raises(ValueError, match="Generator"):
        tpre.preprocess_batch(torch.zeros(1, 4, 4, 3), training=True)


@pytest.mark.parametrize("change,net", [
    ({"loss": {"l1_weight": 0.8, "l2_weight": 0.2, "perc_weight": 1.0}}, "alex"),
])
def test_trainer_refuses_what_it_does_not_carry(change, net, monkeypatch, tmp_path):
    """The Trainer refuses no config now: a ``loss:`` block without a GAN,
    refused until LPIPS-AlexNet was ported, takes it (as the JAX Trainer)."""
    monkeypatch.setenv("VQVAE_TPU_LPIPS_WEIGHTS_DIR", str(tmp_path))   # no .npz: random init
    cfg = parse_config({**RAW, **change})
    with pytest.warns(UserWarning, match="LPIPS"):
        trainer = Trainer(cfg, learning_rate=1e-3, seed=0, steps_per_epoch=10, device="cpu")
    assert type(trainer.losses.lpips.net).__name__ == {"alex": "AlexNetFeatures"}[net]


def test_trainer_state_and_usage():
    cfg = parse_config(RAW)
    trainer = Trainer(cfg, learning_rate=1e-3, seed=0, steps_per_epoch=10, device="cpu")
    state = trainer.init_state()
    assert state.step == 0 and state.usage_count.dtype == torch.int32
    assert not trainer.gan_active(10**6)
    images = np.random.RandomState(6).randint(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    state, metrics = trainer.train_step(state, {"image": images}, epoch=0)
    assert state.step == 1 and int(state.usage_count.sum()) == 2 * 16
    assert set(metrics) == {"loss", "l1_loss", "l2_loss", "quant_loss", "perc_loss", "gen_loss",
                            "disc_loss", "r1_penalty", "g_weight", "lr"}
    assert metrics["lr"] == trainer.lr_sched(0) and all(
        torch.isfinite(v) for k, v in metrics.items() if k != "lr")
    assert trainer.reset_usage(state).usage_count.sum() == 0
    same = Trainer(dataclasses.replace(cfg), learning_rate=1e-3, seed=0, steps_per_epoch=10,
                   device="cpu").init_state()
    assert torch.equal(same.generator.get_state(), torch.Generator().manual_seed(0).get_state())


@pytest.mark.parametrize("method", ["train_step", "eval_step"])
def test_steps_require_the_epoch(method):
    """A call without ``epoch`` raises TypeError, as the JAX Trainer's does
    (its ``epoch`` has no default): on a config whose GAN starts at a later
    epoch, a default of 0 would train pre-GAN forever without an error."""
    assert (inspect.signature(getattr(JaxTrainer, method)).parameters["epoch"].default
            is inspect.Parameter.empty)
    trainer = Trainer(parse_config(RAW), learning_rate=1e-3, seed=0, steps_per_epoch=10,
                      device="cpu")
    state = trainer.init_state()
    images = np.random.RandomState(7).rand(2, 16, 16, 3).astype(np.float32)
    with pytest.raises(TypeError, match="epoch"):
        getattr(trainer, method)(state, {"image": images})
    assert state.step == 0
