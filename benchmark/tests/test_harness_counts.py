"""The FLOP and byte counts of ``benchmark/flops.py`` against hand
arithmetic at small shapes."""

from __future__ import annotations

import pytest

from benchmark import flops


def conv(cin, cout, k, side):
    """FLOPs of one image through a 'same' k x k conv at side x side."""
    return 2 * cin * cout * k * k * side * side


def small(kind: str) -> dict:
    q = {"ema": {"commitment_cost": 0.25, "decay": 0.95, "epsilon": 1e-5},
         "gumbel": {"straight_through": False, "temp": 1.0, "kl_cost": 5e-4}}[kind]
    return {"image_size": 8,
            "autoencoder": {"channels": 32, "num_res_blocks": 1, "channel_multipliers": [1, 2]},
            "quantizer": {"num_embeddings": 16, "embedding_dim": 8, "type": kind,
                          "params": q},
            "training": {"cumulative_bs": 8, "base_lr": 1e-4, "betas": [0.0, 0.99],
                         "eps": 1e-8, "weight_decay": 1e-4}}


# the encoder of ``small``: stem at 8^2, ResBlock 32->32 at 8^2, ResBlock
# 32->64 (with its 1x1 shortcut) at 4^2, the final ResBlock at 2^2, the 1x1
# conv out to D = 8
ENCODER = (conv(3, 32, 3, 8) + 2 * conv(32, 32, 3, 8)
           + conv(32, 64, 3, 4) + conv(64, 64, 3, 4) + conv(32, 64, 1, 4)
           + 2 * conv(64, 64, 3, 2) + conv(64, 8, 1, 2))
# the decoder: conv in from D = 8 at 2^2, ResBlock 64->64, ResBlock 64->32
# (shortcut) + upsample conv at 4^2, ResBlock 32->32 + upsample conv at 8^2,
# conv out to 3 channels
DECODER = (conv(8, 64, 3, 2) + 2 * conv(64, 64, 3, 2)
           + conv(64, 32, 3, 2) + conv(32, 32, 3, 2) + conv(64, 32, 1, 2) + conv(32, 32, 3, 4)
           + 2 * conv(32, 32, 3, 4) + conv(32, 32, 3, 8)
           + conv(32, 3, 3, 8))


def test_tokenize_is_the_encoder_and_the_distances():
    rows = 2 * 2   # latent positions of one image
    assert flops.tokenize_flops_per_image(small("ema")) == ENCODER + 2 * rows * 16 * 8


def test_detokenize_is_the_decoder():
    assert flops.detokenize_flops_per_image(small("gumbel")) == DECODER


def test_training_is_forward_plus_both_gradients():
    """Every conv's forward, its input gradient (but the stem's: the images
    need none) and its weight gradient; the distances take no gradient; the
    augmentation's two tent-weight contractions (12 S^3 per image)."""
    batch = 4
    forward = ENCODER + DECODER
    want = batch * (3 * forward - conv(3, 32, 3, 8) + 2 * 4 * 16 * 8 + 12 * 8 ** 3)
    assert flops.train_step_flops(small("ema"), batch, r1=False) == want


def test_vq_least_time_by_hand():
    got = flops.vq_least_seconds(8192, 4096, 256, stats=True)
    assert got["ops"] == 2 * 8192 * 4096 * 256
    assert got["bytes"] == 4 * (8192 * 256 + 4096 * 256 + 8192 + 4096 + 4096 * 256)
    assert got["bound"] == "operations"
    assert got["seconds"] == pytest.approx(got["ops"] / 989e12)
    small_m = flops.vq_least_seconds(1, 4096, 256, stats=False)
    assert small_m["bound"] == "bytes"
    assert small_m["seconds"] == pytest.approx(4 * (256 + 4096 * 256 + 1) / 3.35e12)


def test_gan_count_averages_one_r1_cycle():
    from benchmark.tests.tiny import tiny_config
    cfg = tiny_config("gumbel_vqgan")
    plain = flops.train_step_flops(cfg, 4, r1=False)
    r1 = flops.train_step_flops(cfg, 4, r1=True)
    assert r1 > plain
    assert flops.train_flops_per_image(cfg, 4) == pytest.approx((15 * plain + r1) / 16 / 4)
