"""The EMA quantizer of the PyTorch port against
``vqvae_tpu.models.quantizers.EMAVectorQuantizer`` on the CPU: one
``train=True`` forward from one numpy state gives the same codes (exact),
loss (rtol 1e-5) and EMA buffers (rtol 1e-5 / atol 1e-6); without
``train=True`` nothing moves the buffers, in any module mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.models.quantizers import EMAVectorQuantizer as JaxEMA
from vqvae_tpu_torch.config import parse_config
from vqvae_tpu_torch.models.quantizers import EMAVectorQuantizer
from vqvae_tpu_torch.models.vqvae import VQVAE

torch.set_num_threads(1)

N, D, DECAY, EPS = 32, 8, 0.95, 1e-5


def _state(seed):
    rs = np.random.RandomState(seed)
    return {"codebook": (0.5 * rs.randn(N, D)).astype(np.float32),
            "ema_count": rs.uniform(0.0, 3.0, N).astype(np.float32),
            "ema_weight": rs.randn(N, D).astype(np.float32)}


def _port_quantizer(state):
    q = EMAVectorQuantizer(N, D, 0.25, DECAY, EPS)
    q.load_state_dict({"codebook.weight": torch.from_numpy(state["codebook"]),
                       "ema_count": torch.from_numpy(state["ema_count"]),
                       "ema_weight": torch.from_numpy(state["ema_weight"])}, strict=True)
    return q


@pytest.mark.parametrize("masked", [False, True])
def test_train_forward_matches_jax(masked):
    state = _state(31)
    z = np.random.RandomState(32).randn(4, 4, 4, D).astype(np.float32)  # NHWC
    mask = np.array([True, False, True, True]) if masked else None
    jq = JaxEMA(N, D, commitment_cost=0.25, decay=DECAY, epsilon=EPS)
    (q_j, codes_j, loss_j), new = jq.apply(
        {"vq_state": jax.tree.map(jnp.asarray, state)}, jnp.asarray(z), train=True,
        mask=None if mask is None else jnp.asarray(mask), mutable=["vq_state"])

    tq = _port_quantizer(state)
    assert not list(tq.parameters())  # buffers only: nothing for the optimizer
    z_t = torch.from_numpy(z).permute(0, 3, 1, 2).requires_grad_()
    q_t, codes_t, loss_t = tq(z_t, train=True,
                              mask=None if mask is None else torch.from_numpy(mask))

    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    # the lookup reads the codebook from before the update
    np.testing.assert_allclose(q_t.detach().permute(0, 2, 3, 1).numpy(), np.asarray(q_j),
                               rtol=1e-6, atol=1e-6)
    for key, buf in (("ema_count", tq.ema_count), ("ema_weight", tq.ema_weight),
                     ("codebook", tq.codebook.weight)):
        np.testing.assert_allclose(buf.numpy(), np.asarray(new["vq_state"][key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    assert not np.allclose(tq.codebook.weight.numpy(), state["codebook"])
    # the loss is the commitment term: its gradient reaches the latents
    loss_t.backward()
    assert z_t.grad.abs().sum() > 0


def test_buffers_move_only_with_train_true():
    cfg = parse_config({
        "image_size": 16,
        "autoencoder": {"channels": 32, "num_res_blocks": 1, "channel_multipliers": [1, 2]},
        "quantizer": {"type": "ema", "num_embeddings": N, "embedding_dim": D,
                      "params": {"commitment_cost": 0.25, "decay": DECAY, "epsilon": EPS}},
    })
    model = VQVAE.from_config(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    model.train()  # the module mode must not matter
    images = torch.from_numpy(np.random.RandomState(33).rand(2, 16, 16, 3).astype(np.float32))
    before = {k: v.clone() for k, v in model.quantizer.state_dict().items()}
    assert set(before) == {"codebook.weight", "ema_count", "ema_weight"}

    model(images * 2 - 1)
    model.reconstruct(images)
    tokens = model.get_tokens(images)
    model.reconstruct_from_tokens(tokens)
    for k, v in model.quantizer.state_dict().items():
        assert torch.equal(v, before[k]), k

    model(images * 2 - 1, train=True)
    after = model.quantizer.state_dict()
    assert all(not torch.equal(after[k], before[k]) for k in before)
