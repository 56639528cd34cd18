"""The Trainer of the non-GAN training step (counterpart of
``vqvae_tpu/train/loop.py:86-317``: ``init_state``, ``train_step``,
``eval_step``, ``reset_usage``, ``gan_active``).

Runs on the card unless ``device="cpu"`` is passed. Not ported yet, each
raising where a config asks for it: ``grad_accum_steps > 1`` and a ``loss:``
block (LPIPS, GAN). Later work (ROADMAP.md queue A): dead-code reinit
(``reinit_every_n_epochs``), the native LR twin, ``run_training`` with its
loaders, checkpoints and CLI.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch

from vqvae_tpu_torch.config import Config
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.train import steps
from vqvae_tpu_torch.train.optim import make_ae_optimizer
from vqvae_tpu_torch.train.schedules import build_lr_schedule
from vqvae_tpu_torch.train.state import TrainState


@dataclass
class Trainer:
    cfg: Config
    learning_rate: float
    seed: int
    steps_per_epoch: int
    compute_dtype: torch.dtype = torch.float32
    # train-time augmentations (the reference's always-on behaviour); False =
    # normalize only, for the parity tests against the JAX Trainer
    augment: bool = True
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        cfg = self.cfg
        t = cfg.training
        if t.grad_accum_steps > 1:
            raise NotImplementedError(
                "grad_accum_steps > 1 is not ported yet (ROADMAP.md queue A, item 6)")
        if cfg.loss is not None:
            raise NotImplementedError(
                "a loss: block (LPIPS, GAN) is not ported yet (ROADMAP.md queue A, item 14)")
        self.device = torch.device(self.device)
        self.lr_sched = build_lr_schedule(self.learning_rate, self.steps_per_epoch,
                                          t.warmup_epochs, t.decay_epochs)

    def init_state(self) -> TrainState:
        """A fresh state: the model's weights drawn from ``seed`` (the same on
        every device), a fresh optimizer, the augmentation generator seeded
        from ``seed``, and zero usage."""
        cfg = self.cfg
        t = cfg.training
        model = VQVAE.from_config(cfg, dtype=self.compute_dtype, device=self.device,
                                  generator=torch.Generator().manual_seed(self.seed))
        model.train()
        return TrainState(
            step=0, model=model,
            optimizer=make_ae_optimizer(model, t.betas, t.eps, t.weight_decay),
            generator=torch.Generator().manual_seed(self.seed),
            usage_count=torch.zeros(cfg.quantizer.num_embeddings, dtype=torch.int32,
                                    device=self.device))

    def gan_active(self, epoch: int) -> bool:
        return False

    def _images(self, batch) -> torch.Tensor:
        return torch.as_tensor(batch["image"], device=self.device)

    def train_step(self, state: TrainState, batch, epoch: int = 0):
        """-> (state, metrics); ``batch["image"]`` is a [0,1] float or uint8
        NHWC batch. The state is updated in place and returned."""
        metrics = steps.train_step(state, self._images(batch), self.lr_sched(state.step),
                                   self.augment, self.cfg.image_size)
        return state, metrics

    def eval_step(self, state: TrainState, batch, epoch: int = 0):
        """-> (metrics, usage, reconstructions); ``batch["mask"]`` (B,) bool
        marks the valid rows (all of them when absent)."""
        images = self._images(batch)
        mask = batch.get("mask")
        if mask is None:
            return steps.eval_step(state, images, torch.ones(
                images.shape[0], dtype=torch.bool, device=self.device))
        return steps.eval_step(state, images, torch.as_tensor(mask, device=self.device))

    def reset_usage(self, state: TrainState) -> TrainState:
        state.usage_count.zero_()
        return state
