"""Shared by ``test_torch_train_standard.py`` and ``test_torch_train_ema.py``:
the port's ``Trainer`` against the JAX package's on the CPU, from one state.

Both sides run fp32 without augmentations (``augment=False``, as
``tests/test_trajectory_parity.py`` runs the JAX Trainer), start from the JAX
Trainer's initial weights (and EMA state) copied through
``vqvae_tpu_torch.utils.convert``, take the same 24 batches, and evaluate one
masked batch after the first. Checked, at these tolerances:
- step 1's gradients, rtol 1e-3 / atol 1e-6 (ROADMAP.md), against
  ``jax.grad`` of the loss the JAX step forms (``q_loss + l2``);
- step 1's metrics, rtol 1e-4, its usage histogram, exact, and the EMA
  buffers after it, rtol 1e-5;
- the masked eval step after step 1: metrics rtol 1e-4, usage exact;
- the 24-step ``loss`` / ``l2_loss`` / ``quant_loss`` trajectories, rtol 5e-3 /
  atol 1e-5 (the tolerance of ``test_mse_trajectory_parity``), which must
  descend by 10%.
One JAX Trainer per file keeps each file to one compile of each step, and
``--dist loadfile`` runs the two files on two workers.
"""

import jax
import jax.numpy as jnp
import numpy as np

from vqvae_tpu.config import parse_config as jax_parse_config
from vqvae_tpu.models.preprocess import preprocess_batch as jax_preprocess
from vqvae_tpu.train.loop import Trainer as JaxTrainer
from vqvae_tpu_torch.config import parse_config
from vqvae_tpu_torch.train.loop import Trainer
from vqvae_tpu_torch.utils.convert import convert_vqvae_variables

N_STEPS, BATCH, IMG, LR = 24, 8, 16, 1e-3
NRB, LEVELS = 1, 2
EVAL_MASK = np.array([True] * 6 + [False] * 2)


def raw_config(q_type: str) -> dict:
    params = {"standard": {"commitment_cost": 0.25},
              "ema": {"commitment_cost": 0.25, "decay": 0.95, "epsilon": 1e-5}}[q_type]
    return {
        "image_size": IMG,
        "autoencoder": {"channels": 32, "num_res_blocks": NRB, "channel_multipliers": [1, 2]},
        "quantizer": {"type": q_type, "num_embeddings": 32, "embedding_dim": 8,
                      "reinit_every_n_epochs": None, "params": params},
        # cosine decay over the 24 steps: the LR moves inside the window
        "training": {"cumulative_bs": BATCH, "base_lr": LR, "betas": [0.0, 0.99],
                     "eps": 1e-8, "weight_decay": 1e-4, "decay_epochs": 1, "max_epochs": 300},
    }


def _jax_gradients(trainer, state, raw_images):
    """jax.grad of the first step's loss, as the JAX non-GAN step forms it."""
    x = jax_preprocess(jnp.asarray(raw_images))
    vq = state.vq_state

    def loss_fn(params):
        if vq is None:
            recon, q_loss, _ = trainer.model.apply({"params": params}, x, train=True)
        else:
            (recon, q_loss, _), _ = trainer.model.apply(
                {"params": params, "vq_state": vq}, x, train=True, mutable=["vq_state"])
        return q_loss + jnp.mean((x - recon) ** 2)

    return jax.device_get(jax.jit(jax.grad(loss_fn))(state.params))


def run_pair(q_type: str) -> dict:
    raw = raw_config(q_type)
    jt = JaxTrainer(cfg=jax_parse_config(raw), learning_rate=LR, seed=0,
                    steps_per_epoch=N_STEPS, mesh=None, compute_dtype=jnp.float32,
                    remat=False, augment=False)
    try:
        state = jt.init_state()
        # copies: the JAX train step donates the state's buffers
        variables = jax.tree.map(np.array, {"params": state.params, **(
            {"vq_state": state.vq_state} if state.vq_state is not None else {})})
        tt = Trainer(parse_config(raw), learning_rate=LR, seed=0, steps_per_epoch=N_STEPS,
                     augment=False, device="cpu")
        ts = tt.init_state()
        ts.model.load_state_dict(convert_vqvae_variables(variables, NRB, LEVELS), strict=True)
        batches = np.random.RandomState(42).rand(N_STEPS, BATCH, IMG, IMG, 3).astype(np.float32)

        grads = _jax_gradients(jt, state, batches[0])
        param_names = dict(ts.model.named_parameters()).keys()
        want_grads = {k: v for k, v in convert_vqvae_variables(
            {**variables, "params": grads}, NRB, LEVELS).items() if k in param_names}

        out = {"q_type": q_type, "traj_jax": [], "traj_port": []}
        for i, b in enumerate(batches):
            state, mj = jt.train_step(state, {"image": jnp.asarray(b)}, epoch=0)
            ts, mt = tt.train_step(ts, {"image": b}, epoch=0)
            out["traj_jax"].append({k: float(v) for k, v in jax.device_get(mj).items()})
            out["traj_port"].append({k: float(v) for k, v in mt.items()})
            if i == 0:
                out["grads"] = ({k: p.grad.clone() for k, p in ts.model.named_parameters()},
                                want_grads)
                out["buffers"] = ({k: v.clone() for k, v in ts.model.quantizer.named_buffers()},
                                  jax.tree.map(np.array, state.vq_state))
                out["usage"] = (ts.usage_count.clone(), np.array(state.usage_count))
                # evaluated after one step, while both sides agree to fp32
                # rounding (later steps drift apart by up to the trajectory's
                # tolerance, and codes on near-ties flip)
                images = np.random.RandomState(43).rand(BATCH, IMG, IMG, 3).astype(np.float32)
                mj, uj, _ = jt.eval_step(state, {"image": images, "mask": EVAL_MASK}, epoch=0)
                mt, ut, _ = tt.eval_step(ts, {"image": images, "mask": EVAL_MASK}, epoch=0)
                out["eval"] = (mt, ut, jax.device_get(mj), np.asarray(uj))
        out["usage_total"] = int(ts.usage_count.sum())
    finally:
        jt.native_lr.destroy()
    return out


def check_gradients(pair):
    got, want = pair["grads"]
    assert got.keys() == want.keys()
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-3, atol=1e-6, err_msg=k)
    assert all(g.abs().sum() > 0 for g in got.values())


def check_first_step(pair):
    got, want = pair["traj_port"][0], pair["traj_jax"][0]
    assert set(got) == set(want) == {"loss", "l1_loss", "l2_loss", "quant_loss", "perc_loss",
                                     "gen_loss", "disc_loss", "r1_penalty", "g_weight", "lr"}
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=1e-4, err_msg=k)
    got_usage, want_usage = pair["usage"]
    np.testing.assert_array_equal(got_usage.numpy(), want_usage)
    buffers, vq_state = pair["buffers"]
    if pair["q_type"] == "standard":
        assert buffers == {} and vq_state is None
        return
    q = vq_state["quantizer"]
    for name, key in (("codebook.weight", "codebook"), ("ema_count", "ema_count"),
                      ("ema_weight", "ema_weight")):
        np.testing.assert_allclose(buffers[name].numpy(), q[key], rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def check_trajectory(pair):
    for key in ("loss", "l2_loss", "quant_loss"):
        got = np.array([m[key] for m in pair["traj_port"]])
        want = np.array([m[key] for m in pair["traj_jax"]])
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-5,
                                   err_msg=f"{pair['q_type']} '{key}':\njax  = {want}\nport = {got}")
    for traj in (pair["traj_port"], pair["traj_jax"]):
        assert traj[-1]["loss"] < 0.9 * traj[0]["loss"]
    assert pair["usage_total"] == N_STEPS * BATCH * 16   # accumulated over the epoch


def check_eval(pair):
    metrics, usage, want, want_usage = pair["eval"]
    assert float(metrics["n_valid"]) == float(want["n_valid"]) == EVAL_MASK.sum()
    for k in ("loss", "l1_loss", "l2_loss", "quant_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(want[k]), rtol=1e-4, err_msg=k)
    assert int(usage.sum()) == EVAL_MASK.sum() * 16
    np.testing.assert_array_equal(usage.numpy(), want_usage)
