"""Gradient accumulation of the port's ``Trainer`` (``grad_accum_steps``)
against the JAX ``Trainer`` on the CPU, from one state.

A tiny EMA config (16^2, channels 32, N 32, D 8) at ``grad_accum_steps 2``:
both sides run fp32 without augmentations from the JAX Trainer's initial
weights and EMA state, and take the same 4 batches of 8 (micro-batches of
4). Checked:
- the 4-step ``loss`` / ``l1_loss`` / ``l2_loss`` / ``quant_loss``
  trajectories, rtol 5e-3 / atol 1e-5;
- after step 1, the EMA buffers, rtol 1e-5 / atol 1e-6: both advance them
  once per micro-batch (the JAX scan's carry), so the port's quantizer runs
  twice per step; and the usage histogram, exactly.
And the counterpart of ``tests/test_train_e2e.py:265`` on the port alone:
standard VQ at ``grad_accum_steps 2`` takes the step that accumulation 1
takes on the same batch (a mean of equal means is the mean): metrics
within rtol 1e-5, usage exactly, and the gradients the optimizer sees
within 1e-5 of each tensor's largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_train_parity import IMG, LEVELS, LR, NRB, raw_config
from vqvae_tpu.config import parse_config as jax_parse_config
from vqvae_tpu.train.loop import Trainer as JaxTrainer
from vqvae_tpu_torch.config import parse_config
from vqvae_tpu_torch.train.loop import Trainer
from vqvae_tpu_torch.utils.convert import convert_vqvae_variables

torch.set_num_threads(1)

N_STEPS, BATCH, ACCUM = 4, 8, 2
KEYS = ("loss", "l1_loss", "l2_loss", "quant_loss")


def accum_config(q_type: str, accum: int) -> dict:
    raw = raw_config(q_type)
    raw["training"] = {**raw["training"], "cumulative_bs": BATCH, "grad_accum_steps": accum}
    return raw


@pytest.fixture(scope="module")
def ema_pair():
    raw = accum_config("ema", ACCUM)
    jt = JaxTrainer(cfg=jax_parse_config(raw), learning_rate=LR, seed=0,
                    steps_per_epoch=N_STEPS, mesh=None, compute_dtype=jnp.float32,
                    remat=False, augment=False)
    try:
        state = jt.init_state()
        variables = jax.tree.map(np.array, {"params": state.params, "vq_state": state.vq_state})
        tt = Trainer(parse_config(raw), learning_rate=LR, seed=0, steps_per_epoch=N_STEPS,
                     augment=False, device="cpu")
        ts = tt.init_state()
        ts.model.load_state_dict(convert_vqvae_variables(variables, NRB, LEVELS), strict=True)
        calls = []
        ts.model.quantizer.register_forward_hook(
            lambda m, args, kwargs, out: calls.append(kwargs.get("train")), with_kwargs=True)
        batches = np.random.RandomState(42).rand(N_STEPS, BATCH, IMG, IMG, 3).astype(np.float32)
        out = {"jax": [], "port": []}
        for i, b in enumerate(batches):
            state, mj = jt.train_step(state, {"image": jnp.asarray(b)}, epoch=0)
            ts, mt = tt.train_step(ts, {"image": b}, epoch=0)
            out["jax"].append({k: float(v) for k, v in jax.device_get(mj).items()})
            out["port"].append({k: float(v) for k, v in mt.items()})
            if i == 0:
                out["buffers"] = ({k: v.clone() for k, v in ts.model.quantizer.named_buffers()},
                                  jax.tree.map(np.array, state.vq_state["quantizer"]))
                out["usage"] = (ts.usage_count.clone(), np.array(state.usage_count))
                out["calls"] = list(calls)
    finally:
        jt.native_lr.destroy()
    return out


def test_accumulated_trajectory_matches_jax(ema_pair):
    assert set(ema_pair["port"][0]) == set(ema_pair["jax"][0])
    for key in KEYS:
        got = np.array([m[key] for m in ema_pair["port"]])
        want = np.array([m[key] for m in ema_pair["jax"]])
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-5,
                                   err_msg=f"'{key}':\njax  = {want}\nport = {got}")
    np.testing.assert_allclose([m["lr"] for m in ema_pair["port"]],
                               [m["lr"] for m in ema_pair["jax"]], rtol=1e-6)


def test_ema_buffers_advance_once_per_micro_batch(ema_pair):
    assert ema_pair["calls"] == [True] * ACCUM
    buffers, q = ema_pair["buffers"]
    for name, key in (("codebook.weight", "codebook"), ("ema_count", "ema_count"),
                      ("ema_weight", "ema_weight")):
        np.testing.assert_allclose(buffers[name].numpy(), q[key], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    got_usage, want_usage = ema_pair["usage"]
    assert int(got_usage.sum()) == BATCH * (IMG // 2 ** LEVELS) ** 2
    np.testing.assert_array_equal(got_usage.numpy(), want_usage)


def test_standard_accumulation_equals_one_full_batch():
    images = np.random.RandomState(0).randint(0, 256, (BATCH, IMG, IMG, 3)).astype(np.uint8)
    runs = {}
    for accum in (1, ACCUM):
        cfg = parse_config(accum_config("standard", accum))
        trainer = Trainer(cfg, learning_rate=LR, seed=0, steps_per_epoch=N_STEPS,
                          augment=False, device="cpu")
        assert trainer.accum == accum
        state = trainer.init_state()
        state, metrics = trainer.train_step(state, {"image": images}, epoch=0)
        grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
        runs[accum] = (metrics, state.usage_count.clone(), grads)
    (m1, u1, g1), (m2, u2, g2) = runs[1], runs[ACCUM]
    for k in KEYS:
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-5, err_msg=k)
    assert torch.equal(u1, u2)
    # a bias just before a GroupNorm has a gradient that is 0 but for
    # rounding: its scale is at least 1e-3 of the model's largest entry
    floor = 1e-3 * max(float(g.abs().max()) for g in g1.values())
    for k, g in g1.items():
        scale = max(float(g.abs().max()), floor)
        assert float((g2[k] - g).abs().max()) <= 1e-5 * scale, k


def test_batch_must_divide_into_micro_batches():
    trainer = Trainer(parse_config(accum_config("standard", 3)), learning_rate=LR, seed=0,
                      steps_per_epoch=N_STEPS, augment=False, device="cpu")
    state = trainer.init_state()
    with pytest.raises(ValueError, match="grad_accum_steps=3"):
        trainer.train_step(state, {"image": np.zeros((BATCH, IMG, IMG, 3), np.uint8)}, epoch=0)
    assert state.step == 0
