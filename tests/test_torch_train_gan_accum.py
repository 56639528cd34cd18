"""The port's GAN step with adaptive lambda and gradient accumulation
against the JAX ``Trainer`` on the CPU, from one state.

The tiny gumbel-VQGAN config of ``test_torch_train_gan.py`` (16^2, channels
32, N 32, D 8, a D with ``channel_base 256``, the gumbel noise zeroed on
both sides) with ``use_adaptive: true``, ``perc_weight 1``,
``grad_accum_steps 2`` (micro-batches of 4) and ``r1_reg_every 2``; fp32,
no augmentations, the JAX Trainer's autoencoder, D and LPIPS weights
carried across. Three steps: R1, plain, R1. Checked:
- step 0's ``g_weight`` (the micro-batches' mean of lambda * g_weight),
  rtol 1e-3, and every step's, rtol 5e-3;
- the first step's update of every autoencoder and D weight, rtol 1e-3 /
  atol 1e-4 of the tensor's largest update (at least 1e-3 of the module's:
  a bias before a GroupNorm has a gradient that is 0 but for rounding),
  plus one fp32 spacing of the
  stored weight (the update is read as the difference of two stored
  weights). AdamW's eps is 1 and the LR 1e-2 here, not 1e-8 and 1e-4: with
  beta1 0 the first update is ``lr g / (|g| + eps)``, which at eps 1e-8 is
  ``lr sign(g)`` and turns a rounding-level gradient entry (a bias before a
  GroupNorm) into a full-size step of either sign; at eps 1 the update
  follows the gradient, and at LR 1e-2 it is ~1e-5, a thousand spacings of
  a weight of 0.1;
- the 3-step trajectories of the losses, rtol 5e-3 / atol 1e-5, with R1 > 0
  on steps 0 and 2 only, and one D step per optimizer step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.config import parse_config as jax_parse_config
from vqvae_tpu.train.loop import Trainer as JaxTrainer
from vqvae_tpu_torch.config import parse_config
from vqvae_tpu_torch.models import quantizers as tq
from vqvae_tpu_torch.train.loop import Trainer
from vqvae_tpu_torch.utils.convert import convert_discriminator_params, convert_vqvae_variables

from test_torch_train_gan import DISC_KWARGS, IMG, LEVELS, NRB, RAW as GAN_RAW

torch.set_num_threads(1)

N_STEPS, BATCH, LR = 3, 8, 1e-2
KEYS = ("loss", "l1_loss", "l2_loss", "quant_loss", "perc_loss", "gen_loss", "disc_loss",
        "r1_penalty")
RAW = {
    **GAN_RAW,
    "loss": {**GAN_RAW["loss"], "adversarial_params": {
        **GAN_RAW["loss"]["adversarial_params"], "use_adaptive": True, "r1_reg_every": 2}},
    "training": {**GAN_RAW["training"], "cumulative_bs": BATCH, "grad_accum_steps": 2,
                 "eps": 1.0},
}


def _jax_weights(state):
    return (convert_vqvae_variables({"params": jax.device_get(state.params)}, NRB, LEVELS),
            convert_discriminator_params(jax.device_get(state.disc_params)))


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "gumbel",
               lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
    mp.setattr(tq, "gumbel_noise",
               lambda shape, device, generator=None: torch.zeros(shape, device=device))
    jt = JaxTrainer(cfg=jax_parse_config(RAW), learning_rate=LR, seed=0,
                    steps_per_epoch=N_STEPS, mesh=None, compute_dtype=jnp.float32, remat=False,
                    augment=False, disc_kwargs=DISC_KWARGS)
    try:
        state = jt.init_state()
        params = jax.tree.map(np.array, state.params)
        dparams = jax.tree.map(np.array, state.disc_params)
        lpips_params = jax.tree.map(np.array, jt.lpips_params)
        before = _jax_weights(state)
        batches = np.random.RandomState(42).rand(N_STEPS, BATCH, IMG, IMG, 3).astype(np.float32)
        out = {"jax": []}
        for i, b in enumerate(batches):
            state, m = jt.train_step(state, {"image": jnp.asarray(b)}, epoch=0)
            out["jax"].append({k: float(v) for k, v in jax.device_get(m).items()})
            if i == 0:
                out["jax_after"] = _jax_weights(state)

        tt = Trainer(parse_config(RAW), learning_rate=LR, seed=0, steps_per_epoch=N_STEPS,
                     augment=False, device="cpu", lpips_params_override=lpips_params,
                     disc_kwargs=DISC_KWARGS)
        ts = tt.init_state()
        ts.model.load_state_dict(convert_vqvae_variables({"params": params}, NRB, LEVELS),
                                 strict=True)
        ts.disc.load_state_dict(convert_discriminator_params(dparams), strict=True)
        out["port"] = []
        for i, b in enumerate(batches):
            ts, m = tt.train_step(ts, {"image": b}, epoch=0)
            out["port"].append({k: float(v) for k, v in m.items()})
            if i == 0:
                out["port_after"] = tuple({k: v.clone() for k, v in m.state_dict().items()}
                                          for m in (ts.model, ts.disc))
        out["before"] = before
        out["disc_step"] = ts.disc_step
    finally:
        jt.native_lr.destroy()
        mp.undo()
    return out


def test_adaptive_g_weight_matches_jax(runs):
    got = np.array([m["g_weight"] for m in runs["port"]])
    want = np.array([m["g_weight"] for m in runs["jax"]])
    assert np.isfinite(got).all() and (got > 0).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
    np.testing.assert_allclose(got, want, rtol=5e-3)


@pytest.mark.parametrize("module", [0, 1], ids=["autoencoder", "discriminator"])
def test_first_step_updates_match_jax(runs, module):
    before, got_after, want_after = (runs["before"][module], runs["port_after"][module],
                                     runs["jax_after"][module])
    assert set(got_after) == set(want_after) == set(before)
    updates = {k: (got_after[k].double() - w0.double(), want_after[k].double() - w0.double())
               for k, w0 in before.items()}
    floor = 1e-3 * max(float(want.abs().max()) for _, want in updates.values())
    for k, (got, want) in updates.items():
        spacing = np.spacing(np.abs(want_after[k].numpy().astype(np.float32)))
        limit = (1e-3 * want.abs().numpy() + 1e-4 * max(float(want.abs().max()), floor)
                 + spacing)
        excess = (got - want).abs().numpy() - limit
        assert (excess <= 0).all(), (k, float(excess.max()), float(want.abs().max()))


def test_accumulated_gan_trajectory_matches_jax(runs):
    got, want = runs["port"], runs["jax"]
    for key in KEYS:
        g = np.array([m[key] for m in got])
        w = np.array([m[key] for m in want])
        np.testing.assert_allclose(g, w, rtol=5e-3, atol=1e-5,
                                   err_msg=f"'{key}':\njax  = {w}\nport = {g}")
    assert list(np.nonzero([m["r1_penalty"] for m in got])[0]) == [0, 2]
    assert runs["disc_step"] == N_STEPS
