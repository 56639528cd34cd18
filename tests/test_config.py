import math

import pytest

from vqvae_tpu.config import load_config, parse_config

STANDARD = {
    "image_size": 64,
    "autoencoder": {"channels": 32, "num_res_blocks": 2,
                    "channel_multipliers": [1, 2]},
    "quantizer": {"num_embeddings": 128, "embedding_dim": 16,
                  "type": "standard", "params": {"commitment_cost": 0.25},
                  "reinit_every_n_epochs": None},
    "training": {"cumulative_bs": 256, "base_lr": 1e-4, "betas": [0.0, 0.99],
                 "eps": 1e-8, "weight_decay": 1e-4, "decay_epochs": 250,
                 "max_epochs": 300},
}


def test_parse_standard():
    cfg = parse_config(STANDARD)
    assert cfg.image_size == 64
    assert cfg.autoencoder.compression == 4
    assert cfg.latent_size == 16
    assert cfg.quantizer.type == "standard"
    assert not cfg.use_adversarial
    assert cfg.encoder_out_channels == 16
    assert cfg.training.scaled_lr() == pytest.approx(1e-4)


def test_gumbel_encoder_channels():
    raw = dict(STANDARD)
    raw["quantizer"] = {"num_embeddings": 1024, "embedding_dim": 256,
                        "type": "gumbel", "reinit_every_n_epochs": None,
                        "params": {"straight_through": False, "temp": 1.0,
                                   "kl_cost": 0.00859375,
                                   "kl_warmup_epochs": 0.48,
                                   "temp_decay_epochs": 15,
                                   "temp_final": 0.0625}}
    cfg = parse_config(raw)
    assert cfg.encoder_out_channels == 1024


def test_sqrt_lr_scaling():
    raw = dict(STANDARD)
    raw["training"] = dict(raw["training"], cumulative_bs=1024)
    cfg = parse_config(raw)
    assert cfg.training.scaled_lr() == pytest.approx(1e-4 * math.sqrt(4))


def test_bad_quantizer_type():
    raw = dict(STANDARD)
    raw["quantizer"] = dict(raw["quantizer"], type="bogus")
    with pytest.raises(ValueError):
        parse_config(raw)


def test_reference_yaml_schema_loads():
    """All five reference example configs must parse unchanged."""
    import glob
    import os
    confs = sorted(glob.glob("/root/reference/example_confs/*.yaml"))
    if not confs:
        pytest.skip("reference confs not available")
    for path in confs:
        cfg = load_config(path)
        assert cfg.image_size == 256
        assert cfg.autoencoder.compression == 16
        if "vqgan" in os.path.basename(path):
            assert cfg.use_adversarial
            assert cfg.loss.adversarial.start_epoch == 100


def test_local_example_confs_load():
    """Every config shipped in example_confs/ must parse."""
    import glob
    import os
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    confs = sorted(glob.glob(os.path.join(here, "example_confs", "*.yaml")))
    assert len(confs) >= 6, confs
    for path in confs:
        cfg = load_config(path)
        # MoVQ decodes at Kandinsky 2.2's 512^2; every other config at 256^2
        if os.path.basename(path) == "kandinsky22_movq.yaml":
            assert cfg.image_size == 512
        else:
            assert cfg.image_size == 256
        if "1chip" in os.path.basename(path):
            assert cfg.training.grad_accum_steps == 8
