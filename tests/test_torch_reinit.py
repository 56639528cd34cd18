"""Dead-code reinit of the port against the JAX package on the CPU.

- The apply halves (``reinit_unused_codes``, ``reinit_unused_codes_ema``)
  equal JAX's ``reinit_unused_codes{,_ema}`` exactly when given JAX's own
  picks (its categorical draw and its normal noise, taken from the same
  key the way the JAX function takes them); with ``noise_scale`` 0.1 within
  5e-7 of each value and of the tensor's largest (the last bit of the
  codebook's std, summed in another order).
- The pick half draws only used codes, is fixed by the generator's seed,
  and after an EMA apply every replaced row keeps
  ``codebook == ema_weight / ema_count`` (rtol 1e-6) while the other rows
  stay as they were.
- ``Trainer.maybe_reinit_codes`` leaves epoch 0 alone and follows
  ``reinit_every_n_epochs``, for the standard and the EMA quantizer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_train_parity import LR, raw_config
from vqvae_tpu.models import quantizers as jq
from vqvae_tpu_torch.config import parse_config
from vqvae_tpu_torch.models import quantizers as tq
from vqvae_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

N, D = 64, 8


def _case(seed: int):
    rs = np.random.RandomState(seed)
    codebook = rs.randn(N, D).astype(np.float32)
    counts = rs.randint(1, 50, N).astype(np.float32)
    counts[rs.rand(N) < 0.4] = 0.0           # dead codes
    probs = counts / counts.sum()
    ema_count = rs.rand(N).astype(np.float32) * 5 + 0.5
    ema_weight = (codebook * ema_count[:, None]).astype(np.float32)
    return codebook, probs, ema_weight, ema_count


def _jax_picks(probs, key):
    """The picks JAX's reinit takes from ``key`` (quantizers.py:108-117)."""
    rng_pick, rng_noise = jax.random.split(key)
    replacements = jax.random.categorical(rng_pick, jnp.log(jnp.asarray(probs) + 1e-30),
                                          shape=(N,))
    noise = jax.random.normal(rng_noise, (N, D), jnp.float32)
    return torch.from_numpy(np.array(replacements)).long(), torch.from_numpy(np.array(noise))


@pytest.mark.parametrize("noise_scale", [0.0, 0.1])
def test_apply_equals_jax_on_the_same_picks(noise_scale):
    codebook, probs, ema_weight, ema_count = _case(0)
    key = jax.random.PRNGKey(5)
    replacements, noise = _jax_picks(probs, key)
    # exact without noise; with it, the per-dimension std's reduction order
    # (XLA's against torch's) leaves the last bit of some rows to rounding
    check = (np.testing.assert_array_equal if noise_scale == 0.0 else
             lambda g, w: np.testing.assert_allclose(g, w, rtol=5e-7,
                                                     atol=5e-7 * np.abs(w).max()))
    t = torch.from_numpy
    want = np.asarray(jq.reinit_unused_codes(jnp.asarray(codebook), jnp.asarray(probs), key,
                                             noise_scale=noise_scale))
    got = tq.reinit_unused_codes(t(codebook), t(probs), replacements, noise, noise_scale)
    check(got.numpy(), want)
    want_ema = jq.reinit_unused_codes_ema(jnp.asarray(codebook), jnp.asarray(ema_weight),
                                          jnp.asarray(ema_count), jnp.asarray(probs), key,
                                          noise_scale=noise_scale)
    got_ema = tq.reinit_unused_codes_ema(t(codebook), t(ema_weight), t(ema_count), t(probs),
                                         replacements, noise, noise_scale)
    for g, w in zip(got_ema, want_ema):
        check(g.numpy(), np.asarray(w))
    assert not np.array_equal(got.numpy(), codebook)


def test_pick_draws_used_codes_and_keeps_the_ema_invariant():
    codebook, probs, ema_weight, ema_count = _case(1)
    probs = torch.from_numpy(probs)
    replacements, noise = tq.pick_reinit(probs, D, torch.Generator().manual_seed(3))
    assert noise is None and replacements.shape == (N,) and replacements.dtype == torch.int64
    assert bool((probs[replacements] > 0).all())
    again, _ = tq.pick_reinit(probs, D, torch.Generator().manual_seed(3))
    other, _ = tq.pick_reinit(probs, D, torch.Generator().manual_seed(4))
    assert torch.equal(replacements, again) and not torch.equal(replacements, other)
    _, noise = tq.pick_reinit(probs, D, torch.Generator().manual_seed(3), noise_scale=0.5)
    assert noise.shape == (N, D)

    t = torch.from_numpy
    for noise_scale in (0.0, 0.5):
        cb, w, c = tq.reinit_unused_codes_ema(t(codebook), t(ema_weight), t(ema_count), probs,
                                              replacements, noise, noise_scale)
        dead = probs == 0
        assert int(dead.sum()) > 0
        torch.testing.assert_close(cb[dead], w[dead] / c[dead, None], rtol=1e-6, atol=0)
        assert torch.equal(c[dead], t(ema_count)[replacements][dead])
        assert torch.equal(cb[~dead], t(codebook)[~dead])
        assert torch.equal(w[~dead], t(ema_weight)[~dead]) and torch.equal(c[~dead],
                                                                           t(ema_count)[~dead])
        if noise_scale == 0.0:
            assert torch.equal(cb[dead], t(codebook)[replacements][dead])


@pytest.mark.parametrize("q_type", ["standard", "ema"])
def test_maybe_reinit_follows_the_cadence(q_type):
    raw = raw_config(q_type)
    raw["quantizer"] = {**raw["quantizer"], "reinit_every_n_epochs": 2}
    trainer = Trainer(parse_config(raw), learning_rate=LR, seed=0, steps_per_epoch=4,
                      augment=False, device="cpu")
    state = trainer.init_state()
    q = state.model.quantizer
    if q_type == "ema":   # accumulators as after training: every count > 0
        with torch.no_grad():
            q.ema_count.copy_(torch.linspace(0.5, 3.0, 32))
            q.ema_weight.copy_(q.codebook.weight * q.ema_count[:, None])
    usage = torch.zeros(32, dtype=torch.int32)
    usage[::3] = 7
    dead = usage == 0
    picks = {}
    for epoch in range(5):
        before = {k: v.detach().clone() for k, v in q.state_dict().items()}
        state.usage_count.copy_(usage)
        state = trainer.maybe_reinit_codes(state, epoch)
        after = q.state_dict()
        changed = not torch.equal(after["codebook.weight"], before["codebook.weight"])
        assert changed == (epoch in (2, 4)), epoch
        assert torch.equal(after["codebook.weight"][~dead], before["codebook.weight"][~dead])
        if changed:
            rows = after["codebook.weight"][dead]
            # each dead row is now a copy of a used row (noise_scale 0)
            used = before["codebook.weight"][~dead]
            assert bool((rows[:, None, :] == used[None]).all(-1).any(-1).all())
            picks[epoch] = rows
            if q_type == "ema":
                torch.testing.assert_close(rows, after["ema_weight"][dead]
                                           / after["ema_count"][dead, None], rtol=1e-6, atol=0)
    assert not torch.equal(picks[2], picks[4])   # a seed of its own per epoch
