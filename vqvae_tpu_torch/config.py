"""YAML config loading + schema validation: the port's own copy of
``vqvae_tpu/config.py`` (PyYAML only), so that the port never imports the
JAX package. ``tests/test_torch_import.py`` holds the two parsers equal on
every ``example_confs/*.yaml``.

Schema is byte-compatible with the reference framework's example_confs/*.yaml
(see reference vqvae/common_utils.py:30-35 and the schema documented in
vqvae/model.py:27-77): top-level keys `image_size`, `autoencoder`, `quantizer`,
optional `loss`, and `training`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import yaml

QUANTIZER_TYPES = ("standard", "ema", "gumbel", "entropy")
GAN_LOSS_TYPES = ("hinge", "non-saturating")


def get_model_conf(filepath: str) -> dict:
    """Load a raw YAML config dict (reference: common_utils.py:30-35)."""
    with open(filepath, "r", encoding="utf-8") as stream:
        return yaml.safe_load(stream)


@dataclasses.dataclass(frozen=True)
class AutoencoderConf:
    channels: int
    num_res_blocks: int
    channel_multipliers: tuple
    # spatial compression factor = 2 ** len(channel_multipliers)

    @property
    def compression(self) -> int:
        return 2 ** len(self.channel_multipliers)


@dataclasses.dataclass(frozen=True)
class QuantizerConf:
    type: str
    num_embeddings: int
    embedding_dim: int
    reinit_every_n_epochs: Optional[int]
    params: dict

    def __post_init__(self):
        if self.type not in QUANTIZER_TYPES:
            raise ValueError(f"unrecognized quantizer: {self.type!r} "
                             f"(must be one of {QUANTIZER_TYPES})")


@dataclasses.dataclass(frozen=True)
class AdversarialConf:
    start_epoch: int
    loss_type: str
    g_weight: float
    use_adaptive: bool
    r1_reg_weight: Optional[float]
    r1_reg_every: int

    def __post_init__(self):
        if self.loss_type not in GAN_LOSS_TYPES:
            raise ValueError(f"unknown loss_type: {self.loss_type!r}")


@dataclasses.dataclass(frozen=True)
class LossConf:
    l1_weight: float
    l2_weight: float
    perc_weight: float
    adversarial: Optional[AdversarialConf]


@dataclasses.dataclass(frozen=True)
class TrainingConf:
    cumulative_bs: int
    base_lr: float
    betas: tuple
    eps: float
    weight_decay: float
    warmup_epochs: Optional[float]
    decay_epochs: Optional[float]
    max_epochs: int
    # split each optimizer step into N sequential micro-batches (lax.scan in
    # the compiled step): same global-batch semantics, ~N x less activation
    # memory. Lets the published cumulative_bs=256 recipe run on few chips
    # (the reference relies on having enough GPUs instead). Default 1.
    grad_accum_steps: int = 1

    def scaled_lr(self) -> float:
        """sqrt LR scaling with global batch (reference train.py:63)."""
        return self.base_lr * math.sqrt(self.cumulative_bs / 256)


@dataclasses.dataclass(frozen=True)
class Config:
    image_size: int
    autoencoder: AutoencoderConf
    quantizer: QuantizerConf
    loss: Optional[LossConf]
    training: Optional[TrainingConf]

    @property
    def latent_size(self) -> int:
        return self.image_size // self.autoencoder.compression

    @property
    def use_adversarial(self) -> bool:
        return self.loss is not None and self.loss.adversarial is not None

    @property
    def encoder_out_channels(self) -> int:
        """Encoder output channels: codebook size for gumbel, else latent dim
        (reference model.py:130)."""
        if self.quantizer.type == "gumbel":
            return self.quantizer.num_embeddings
        return self.quantizer.embedding_dim


def _opt(d: dict, key: str, default=None):
    v = d.get(key, default)
    return default if v is None else v


def parse_config(raw: dict) -> Config:
    """Validate + freeze a raw YAML dict into a Config."""
    ae = raw["autoencoder"]
    ae_conf = AutoencoderConf(
        channels=int(ae["channels"]),
        num_res_blocks=int(ae["num_res_blocks"]),
        channel_multipliers=tuple(int(m) for m in ae["channel_multipliers"]),
    )
    if ae_conf.num_res_blocks < 1:
        raise ValueError(
            f"num_res_blocks must be >= 1, got {ae_conf.num_res_blocks} "
            "(each encoder level's downsample is carried by its last block)")

    q = raw["quantizer"]
    q_conf = QuantizerConf(
        type=str(q["type"]),
        num_embeddings=int(q["num_embeddings"]),
        embedding_dim=int(q["embedding_dim"]),
        reinit_every_n_epochs=(int(q["reinit_every_n_epochs"])
                               if q.get("reinit_every_n_epochs") is not None else None),
        params={k: v for k, v in (q.get("params") or {}).items()},
    )

    l_conf = None
    if raw.get("loss") is not None:
        l = raw["loss"]
        adv = None
        if l.get("adversarial_params") is not None:
            a = l["adversarial_params"]
            adv = AdversarialConf(
                start_epoch=int(a["start_epoch"]),
                loss_type=str(a["loss_type"]),
                g_weight=float(a["g_weight"]),
                use_adaptive=bool(a["use_adaptive"]),
                r1_reg_weight=(float(a["r1_reg_weight"])
                               if a.get("r1_reg_weight") is not None else None),
                r1_reg_every=int(_opt(a, "r1_reg_every", 16)),
            )
            if adv.r1_reg_every < 1:
                raise ValueError(
                    f"r1_reg_every must be >= 1, got {adv.r1_reg_every} "
                    "(the host loop computes step % r1_reg_every)")
        l_conf = LossConf(
            l1_weight=float(l["l1_weight"]),
            l2_weight=float(l["l2_weight"]),
            perc_weight=float(l["perc_weight"]),
            adversarial=adv,
        )

    t_conf = None
    if raw.get("training") is not None:
        t = raw["training"]
        t_conf = TrainingConf(
            cumulative_bs=int(t["cumulative_bs"]),
            base_lr=float(t["base_lr"]),
            betas=tuple(float(b) for b in t["betas"]),
            eps=float(t["eps"]),
            weight_decay=float(t["weight_decay"]),
            warmup_epochs=(float(t["warmup_epochs"])
                           if t.get("warmup_epochs") is not None else None),
            decay_epochs=(float(t["decay_epochs"])
                          if t.get("decay_epochs") is not None else None),
            max_epochs=int(t["max_epochs"]),
            grad_accum_steps=int(_opt(t, "grad_accum_steps", 1)),
        )
        if t_conf.grad_accum_steps < 1:
            raise ValueError(
                f"grad_accum_steps must be >= 1, got {t_conf.grad_accum_steps}")

    return Config(
        image_size=int(raw["image_size"]),
        autoencoder=ae_conf,
        quantizer=q_conf,
        loss=l_conf,
        training=t_conf,
    )


def load_config(filepath: str) -> Config:
    return parse_config(get_model_conf(filepath))
