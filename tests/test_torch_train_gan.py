"""The port's gumbel-VQGAN training step (LPIPS-VGG, StyleGAN2 D, R1)
against the JAX ``Trainer`` on the CPU, from one state.

A tiny ``gumbel_vqgan.yaml``-shaped config (16^2, channels 32, N 32, D 8,
the published loss block with ``start_epoch 0`` and ``r1_reg_every 4``, a D
with ``channel_base 256``): both sides run fp32 without augmentations, with
the gumbel noise zeroed (the two draw from unrelated generators), from the
JAX Trainer's autoencoder, D and LPIPS weights carried across. The port runs
twice, with the fused D backward off and on (on the CPU the fused Functions
take the plain versions of B3 and B4, so both must match). Checked, at:
- step 1 (an R1 step): the autoencoder's gradients against ``jax.grad`` of
  ``nll + g_weight g_loss + q_loss`` and D's against ``jax.grad`` of
  ``d_loss + r1``, rtol 1e-3 / atol 1e-4 of each tensor's largest entry (an entry
  near 0 is a difference of terms of that scale);
- a 6-step trajectory of ``loss``, ``l1_loss``, ``l2_loss``, ``quant_loss``,
  ``perc_loss``, ``gen_loss``, ``disc_loss`` and ``r1_penalty``, rtol 5e-3 /
  atol 1e-5, with R1 exactly on steps 1 and 5. The LR is 1e-4: AdamW with
  beta1 0 divides each gradient entry by its own running RMS, so fp32
  rounding in entries near 0 grows step by step through the GAN (at LR 1e-3
  the two sides drift 1.3% apart by step 6; at 1e-4, 0.1%);
- the masked eval step with the GAN active, after step 1, rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.config import parse_config as jax_parse_config
from vqvae_tpu.losses.losses import discriminator_loss, generator_loss, r1_penalty
from vqvae_tpu.models.lpips import LPIPS as JaxLPIPS
from vqvae_tpu.models.preprocess import preprocess_batch as jax_preprocess
from vqvae_tpu.train.loop import Trainer as JaxTrainer
from vqvae_tpu_torch.config import parse_config
from vqvae_tpu_torch.models import quantizers as tq
from vqvae_tpu_torch.train.loop import Trainer
from vqvae_tpu_torch.utils.convert import convert_discriminator_params, convert_vqvae_variables

torch.set_num_threads(1)

N_STEPS, BATCH, IMG, LR = 6, 8, 16, 1e-4
NRB, LEVELS = 1, 2
DISC_KWARGS = {"channel_base": 256}
EVAL_MASK = np.array([True] * 6 + [False] * 2)
KEYS = ("loss", "l1_loss", "l2_loss", "quant_loss", "perc_loss", "gen_loss", "disc_loss",
        "r1_penalty")

RAW = {
    "image_size": IMG,
    "autoencoder": {"channels": 32, "num_res_blocks": NRB, "channel_multipliers": [1, 2]},
    "quantizer": {"type": "gumbel", "num_embeddings": 32, "embedding_dim": 8,
                  "reinit_every_n_epochs": None,
                  "params": {"straight_through": False, "temp": 1.0, "kl_cost": 0.00859375,
                             "kl_warmup_epochs": 0.48, "temp_decay_epochs": 15,
                             "temp_final": 0.0625}},
    "loss": {"l1_weight": 0.8, "l2_weight": 0.2, "perc_weight": 1.0,
             "adversarial_params": {"start_epoch": 0, "loss_type": "non-saturating",
                                    "g_weight": 0.1, "use_adaptive": False,
                                    "r1_reg_weight": 10.0, "r1_reg_every": 4}},
    "training": {"cumulative_bs": BATCH, "base_lr": LR, "betas": [0.0, 0.99], "eps": 1e-8,
                 "weight_decay": 1e-4, "decay_epochs": 1, "max_epochs": 300},
}


def _jax_first_step_grads(jt, params, dparams, raw_images):
    """jax.grad of the first (R1) step's two losses, as the JAX step forms them."""
    cfg = jt.cfg
    adv = cfg.loss.adversarial
    x = jax_preprocess(jnp.asarray(raw_images))
    temp, kl = jt.temp_sched(0), jt.kl_sched(0)
    lpips = JaxLPIPS(net_type="vgg")
    disc = lambda dp, im: jt.disc.apply({"params": dp}, im)

    def ae(p):
        recon, q_loss, _ = jt.model.apply({"params": p}, x, train=True, temp=temp, kl_cost=kl,
                                          rngs={"gumbel": jax.random.PRNGKey(0)})
        nll = (jnp.mean(jnp.abs(x - recon)) * 0.8 + jnp.mean((x - recon) ** 2) * 0.2
               + lpips.apply({"params": jt.lpips_params}, x, recon))
        return nll + generator_loss(disc(dparams, recon), adv.loss_type) * adv.g_weight + q_loss, \
            recon

    g_ae, recon = jax.jit(jax.grad(ae, has_aux=True))(params)
    recon = jax.lax.stop_gradient(recon)

    def d(dp):
        return (discriminator_loss(disc(dp, x), disc(dp, recon), adv.loss_type)
                + r1_penalty(disc, dp, x, adv.r1_reg_weight))

    return jax.device_get(g_ae), jax.device_get(jax.jit(jax.grad(d))(dparams))


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    # zero the noise on both sides; the JAX side before its steps are traced
    mp.setattr(jax.random, "gumbel",
               lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
    mp.setattr(tq, "gumbel_noise",
               lambda shape, device, generator=None: torch.zeros(shape, device=device))
    jt = JaxTrainer(cfg=jax_parse_config(RAW), learning_rate=LR, seed=0,
                    steps_per_epoch=N_STEPS, mesh=None, compute_dtype=jnp.float32, remat=False,
                    augment=False, disc_kwargs=DISC_KWARGS)
    try:
        state = jt.init_state()
        # copies: the JAX train step donates the state's buffers
        params = jax.tree.map(np.array, state.params)
        dparams = jax.tree.map(np.array, state.disc_params)
        lpips_params = jax.tree.map(np.array, jt.lpips_params)
        batches = np.random.RandomState(42).rand(N_STEPS, BATCH, IMG, IMG, 3).astype(np.float32)
        eval_images = np.random.RandomState(43).rand(BATCH, IMG, IMG, 3).astype(np.float32)
        g_ae, g_d = _jax_first_step_grads(jt, params, dparams, batches[0])
        want_grads = (convert_vqvae_variables({"params": g_ae}, NRB, LEVELS),
                      convert_discriminator_params(g_d))

        out = {"jax": {"traj": []}}
        for i, b in enumerate(batches):
            state, m = jt.train_step(state, {"image": jnp.asarray(b)}, epoch=0)
            out["jax"]["traj"].append({k: float(v) for k, v in jax.device_get(m).items()})
            if i == 0:
                m, u, _ = jt.eval_step(state, {"image": eval_images, "mask": EVAL_MASK}, epoch=0)
                out["jax"]["eval"] = ({k: float(v) for k, v in jax.device_get(m).items()},
                                      np.asarray(u))

        for fused in (False, True):
            tt = Trainer(parse_config(RAW), learning_rate=LR, seed=0, steps_per_epoch=N_STEPS,
                         augment=False, device="cpu", lpips_params_override=lpips_params,
                         disc_kwargs=DISC_KWARGS, fused_dbwd=fused, fused_skip=fused)
            ts = tt.init_state()
            ts.model.load_state_dict(convert_vqvae_variables({"params": params}, NRB, LEVELS),
                                     strict=True)
            ts.disc.load_state_dict(convert_discriminator_params(dparams), strict=True)
            run = {"traj": []}
            for i, b in enumerate(batches):
                ts, m = tt.train_step(ts, {"image": b}, epoch=0)
                run["traj"].append({k: float(v) for k, v in m.items()})
                if i == 0:
                    run["grads"] = (
                        {k: p.grad.clone() for k, p in ts.model.named_parameters()},
                        {k: p.grad.clone() for k, p in ts.disc.named_parameters()})
                    m, u, _ = tt.eval_step(ts, {"image": eval_images, "mask": EVAL_MASK}, epoch=0)
                    run["eval"] = ({k: float(v) for k, v in m.items()}, u.numpy())
            run["disc_step"] = ts.disc_step
            out["fused" if fused else "plain"] = run
        out["want_grads"] = want_grads
    finally:
        jt.native_lr.destroy()
        mp.undo()
    return out


@pytest.mark.parametrize("side", ["plain", "fused"])
def test_first_step_gradients_match_jax(runs, side):
    got_ae, got_d = runs[side]["grads"]
    want_ae, want_d = runs["want_grads"]
    assert set(got_ae) == set(want_ae) and set(got_d) == set(want_d)
    for got, want in ((got_ae, want_ae), (got_d, want_d)):
        for k, g in got.items():
            w = want[k].numpy()
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=max(1e-4 * np.abs(w).max(), 1e-7),
                                       err_msg=k)


@pytest.mark.parametrize("side", ["plain", "fused"])
def test_trajectory_matches_jax(runs, side):
    got, want = runs[side]["traj"], runs["jax"]["traj"]
    for key in KEYS:
        g = np.array([m[key] for m in got])
        w = np.array([m[key] for m in want])
        np.testing.assert_allclose(g, w, rtol=5e-3, atol=1e-5,
                                   err_msg=f"{side} '{key}':\njax  = {w}\nport = {g}")
    r1 = np.array([m["r1_penalty"] for m in got])
    assert list(np.nonzero(r1)[0]) == [0, 4]
    for key in ("lr", "gumbel_temperature", "gumbel_kl", "g_weight"):
        np.testing.assert_allclose([m[key] for m in got], [m[key] for m in want], rtol=1e-6,
                                   err_msg=key)
    assert runs[side]["disc_step"] == N_STEPS
    assert all(np.isfinite(m[k]) for m in got for k in KEYS)


@pytest.mark.parametrize("side", ["plain", "fused"])
def test_gan_eval_step_matches_jax(runs, side):
    got, got_usage = runs[side]["eval"]
    want, want_usage = runs["jax"]["eval"]
    assert got["n_valid"] == want["n_valid"] == EVAL_MASK.sum()
    for k in ("loss", "l1_loss", "l2_loss", "quant_loss", "perc_loss", "gen_loss", "disc_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got_usage, want_usage)
