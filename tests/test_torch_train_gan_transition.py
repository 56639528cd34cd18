"""The port's GAN Trainer against the JAX ``Trainer`` on the CPU where
``test_torch_train_gan.py`` does not look: the pre-GAN -> GAN transition,
and the ``hinge`` loss.

Both legs take that file's tiny ``gumbel_vqgan.yaml``-shaped config (16^2,
channels 32, N 32, D 8, LPIPS-VGG, a D with ``channel_base 256``), fp32, no
augmentations, the gumbel noise zeroed on both sides, the JAX Trainer's
weights carried across. One JAX Trainer per leg, built in a module fixture.

(a) ``start_epoch 1``, 4 steps per epoch, ``r1_reg_every 3``, 8 steps across
    the epoch boundary (``decay_epochs 1``: the LR halves over epoch 0, so a
    D schedule that is not shifted by ``start_epoch * steps_per_epoch`` steps
    D twice as far on its first step). Pinned:
    - D's weights and step count do not move before ``start_epoch``, on
      either side (exactly);
    - the port's D LR is the JAX ``disc_lr_sched`` of its step count
      (rtol 1e-6);
    - R1 runs on the global host step: step 6 only, not the GAN phase's
      first step;
    - the losses at every step. Two tiers, as the JAX package's own leg
      (``tests/test_trajectory_parity.py``): rtol 5e-3 / atol 1e-4 over the
      first 6 steps (the phase boundary and two GAN steps), rtol 8e-2 / atol
      2e-4 over all 8. AdamW with beta1 0 moves each weight entry by about
      lr * sign(g), so an entry whose gradient is near fp32 rounding (a conv
      bias before a one-channel GroupNorm group, a D entry near 0) moves by
      an unrelated O(lr) on each side, and the two runs drift apart step by
      step (measured: every loss within 1.0e-3 over steps 0-5, gen_loss
      0.58% apart at step 7);
    - the AE and D weights after every step, as the change from the start
      weights: each step's update has the JAX update's norm within 5e-2 (a
      D LR off by the shift would be 2x; measured within 2.9e-2), and
      ||dW_port - dW_jax|| <= 0.25 ||dW_jax|| over each module's weights
      together (the sign flips above; measured at most 0.151).
(b) ``loss_type: hinge`` at ``start_epoch 0``, 3 steps (R1 on the first),
    the same checks on the losses and weights (``losses/losses.py``'s
    hinge branches of the G and D losses).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_gan import DISC_KWARGS, IMG, LEVELS, LR, NRB, RAW
from vqvae_tpu.config import parse_config as jax_parse_config
from vqvae_tpu.train.loop import Trainer as JaxTrainer
from vqvae_tpu_torch.config import parse_config
from vqvae_tpu_torch.models import quantizers as tq
from vqvae_tpu_torch.train.loop import Trainer
from vqvae_tpu_torch.utils.convert import convert_discriminator_params, convert_vqvae_variables

torch.set_num_threads(1)

BATCH = 8
KEYS = ("loss", "l1_loss", "l2_loss", "quant_loss", "perc_loss", "gen_loss", "disc_loss",
        "r1_penalty")
UPDATE_NORM_RTOL = 5e-2
WEIGHT_GAP = 0.25
TIGHT_STEPS = 6
LEGS = {
    # steps per epoch, start_epoch, r1_reg_every, loss type, steps
    "transition": (4, 1, 3, "non-saturating", 8),
    "hinge": (4, 0, 4, "hinge", 3),
}


def _raw(start_epoch, r1_every, loss_type):
    adv = {**RAW["loss"]["adversarial_params"], "start_epoch": start_epoch,
           "r1_reg_every": r1_every, "loss_type": loss_type}
    return {**RAW, "loss": {**RAW["loss"], "adversarial_params": adv}}


def _flat(sd: dict) -> np.ndarray:
    return np.concatenate([np.asarray(v, np.float64).ravel() for _, v in sorted(sd.items())])


def _adam_count(opt_state) -> int:
    """The step count of an optax AdamW state."""
    counts = {int(v) for path, v in jax.tree_util.tree_flatten_with_path(opt_state)[0]
              if getattr(path[-1], "name", None) == "count"}
    assert len(counts) == 1, counts
    return counts.pop()


def _run(leg):
    steps_per_epoch, start_epoch, r1_every, loss_type, n_steps = LEGS[leg]
    raw = _raw(start_epoch, r1_every, loss_type)
    epochs = [i // steps_per_epoch for i in range(n_steps)]
    batches = np.random.RandomState(44).rand(n_steps, BATCH, IMG, IMG, 3).astype(np.float32)
    mp = pytest.MonkeyPatch()
    # zero the noise on both sides; the JAX side before its steps are traced
    mp.setattr(jax.random, "gumbel",
               lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
    mp.setattr(tq, "gumbel_noise",
               lambda shape, device, generator=None: torch.zeros(shape, device=device))
    jt = JaxTrainer(cfg=jax_parse_config(raw), learning_rate=LR, seed=0,
                    steps_per_epoch=steps_per_epoch, mesh=None, compute_dtype=jnp.float32,
                    remat=False, augment=False, disc_kwargs=DISC_KWARGS)
    try:
        state = jt.init_state()
        # copies: the JAX train step donates the state's buffers
        params = jax.tree.map(np.array, state.params)
        dparams = jax.tree.map(np.array, state.disc_params)
        lpips_params = jax.tree.map(np.array, jt.lpips_params)
        jax_side = {"traj": [], "ae": [], "d": [], "d_count": []}
        for b, epoch in zip(batches, epochs):
            state, m = jt.train_step(state, {"image": jnp.asarray(b)}, epoch=epoch)
            jax_side["traj"].append({k: float(v) for k, v in jax.device_get(m).items()})
            jax_side["ae"].append(_flat(convert_vqvae_variables(
                {"params": jax.tree.map(np.array, state.params)}, NRB, LEVELS)))
            jax_side["d"].append(_flat(convert_discriminator_params(
                jax.tree.map(np.array, state.disc_params))))
            jax_side["d_count"].append(_adam_count(state.disc_opt_state))

        tt = Trainer(parse_config(raw), learning_rate=LR, seed=0,
                     steps_per_epoch=steps_per_epoch, augment=False, device="cpu",
                     lpips_params_override=lpips_params, disc_kwargs=DISC_KWARGS)
        ts = tt.init_state()
        ts.model.load_state_dict(convert_vqvae_variables({"params": params}, NRB, LEVELS),
                                 strict=True)
        ts.disc.load_state_dict(convert_discriminator_params(dparams), strict=True)
        port = {"traj": [], "ae": [], "d": [], "d_step": [], "d_lr": []}
        for b, epoch in zip(batches, epochs):
            ts, m = tt.train_step(ts, {"image": b}, epoch=epoch)
            port["traj"].append({k: float(v) for k, v in m.items()})
            port["ae"].append(_flat({k: v.detach() for k, v in ts.model.state_dict().items()
                                     if k in dict(ts.model.named_parameters())}))
            port["d"].append(_flat({k: v.detach() for k, v in ts.disc.state_dict().items()}))
            port["d_step"].append(ts.disc_step)
            port["d_lr"].append(ts.disc_optimizer.param_groups[0]["lr"])
        want_d_lr = [jt.disc_lr_sched(s - 1) for s in port["d_step"] if s > 0]
    finally:
        jt.native_lr.destroy()
        mp.undo()
    return {"jax": jax_side, "port": port, "epochs": epochs, "want_d_lr": want_d_lr,
            "ae0": _flat({k: v for k, v in convert_vqvae_variables(
                {"params": params}, NRB, LEVELS).items()
                if k in dict(ts.model.named_parameters())}),
            "d0": _flat(convert_discriminator_params(dparams)), "leg": LEGS[leg]}


@pytest.fixture(scope="module", params=list(LEGS))
def run(request):
    return _run(request.param)


def test_losses_match_jax_at_every_step(run):
    got, want = run["port"]["traj"], run["jax"]["traj"]
    for key in KEYS:
        g = np.array([m[key] for m in got])
        w = np.array([m[key] for m in want])
        np.testing.assert_allclose(g[:TIGHT_STEPS], w[:TIGHT_STEPS], rtol=5e-3, atol=1e-4,
                                   err_msg=f"'{key}' early:\njax  = {w}\nport = {g}")
        np.testing.assert_allclose(g, w, rtol=8e-2, atol=2e-4,
                                   err_msg=f"'{key}':\njax  = {w}\nport = {g}")
    for key in ("lr", "gumbel_temperature", "gumbel_kl", "g_weight"):
        np.testing.assert_allclose([m[key] for m in got], [m[key] for m in want], rtol=1e-6,
                                   err_msg=key)


def test_weights_match_jax_at_every_step(run):
    for module, start in (("ae", run["ae0"]), ("d", run["d0"])):
        prev_g = prev_w = start
        for i, (g, w) in enumerate(zip(run["port"][module], run["jax"][module])):
            step = np.linalg.norm(w - prev_w)
            if step == 0:
                assert np.array_equal(g, prev_g), f"{module} moved at step {i} on the port only"
                continue
            ratio = np.linalg.norm(g - prev_g) / step
            assert abs(ratio - 1) <= UPDATE_NORM_RTOL, f"{module} update norm ratio {ratio} at {i}"
            gap = np.linalg.norm(g - w) / np.linalg.norm(w - start)
            assert gap <= WEIGHT_GAP, f"{module} weights at step {i}: gap {gap:.3e}"
            prev_g, prev_w = g, w


def test_discriminator_waits_for_start_epoch(run):
    steps_per_epoch, start_epoch, _, _, n_steps = run["leg"]
    pre = start_epoch * steps_per_epoch
    want_steps = [max(0, i + 1 - pre) for i in range(n_steps)]
    assert run["port"]["d_step"] == want_steps
    assert run["jax"]["d_count"] == want_steps
    for i in range(pre):
        assert np.array_equal(run["port"]["d"][i], run["d0"])
        assert np.array_equal(run["jax"]["d"][i], run["d0"])
        assert run["port"]["traj"][i]["disc_loss"] == run["jax"]["traj"][i]["disc_loss"] == 0
    # the D LR runs on the global step: shifted by the steps D sat out
    d_lr = [lr for lr, s in zip(run["port"]["d_lr"], run["port"]["d_step"]) if s > 0]
    np.testing.assert_allclose(d_lr, run["want_d_lr"], rtol=1e-6)


def test_r1_runs_on_the_global_step(run):
    steps_per_epoch, start_epoch, r1_every, _, n_steps = run["leg"]
    want = [i for i in range(start_epoch * steps_per_epoch, n_steps) if i % r1_every == 0]
    for side in ("port", "jax"):
        r1 = np.array([m["r1_penalty"] for m in run[side]["traj"]])
        assert list(np.nonzero(r1)[0]) == want, side
