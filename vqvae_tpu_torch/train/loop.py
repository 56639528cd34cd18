"""The Trainer (counterpart of ``vqvae_tpu/train/loop.py:86-317``:
``init_state``, ``train_step``, ``eval_step``, ``reset_usage``,
``gan_active``, ``sync_host_step``).

Runs on the card unless ``device="cpu"`` is passed. With a ``loss:`` block
it builds the loss stack: LPIPS-VGG (elided where ``perc_weight == 0``), the
StyleGAN2 discriminator and its optimizer, whose LR schedule is shifted by
the ``start_epoch * steps_per_epoch`` steps D sits out. A host step counter
picks the R1 steps (``host_step % r1_reg_every == 0``) once the GAN is
active. ``fused_dbwd`` / ``fused_skip`` stand for the JAX package's
``VQVAE_TPU_FUSED_DBWD`` / ``VQVAE_TPU_FUSED_SKIP``: the D's first-order
backward through the kernels B3 / B4; off by default, as there.

Not ported yet, each raising where a config asks for it (ROADMAP.md queue
A): ``grad_accum_steps > 1``, adaptive lambda (``use_adaptive: true``), the
entropy quantizer, and LPIPS-AlexNet (a ``loss:`` block without a GAN and
``perc_weight > 0``). Later work: dead-code reinit, the native LR twin,
``run_training`` with its loaders, checkpoints and CLI.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

from vqvae_tpu_torch.config import Config
from vqvae_tpu_torch.models.discriminator import Discriminator
from vqvae_tpu_torch.models.lpips import init_lpips
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.train import steps
from vqvae_tpu_torch.train.optim import make_ae_optimizer, make_disc_optimizer
from vqvae_tpu_torch.train.schedules import build_gumbel_schedules, build_lr_schedule
from vqvae_tpu_torch.train.state import TrainState


def _refuse_unported(cfg: Config) -> None:
    if cfg.training.grad_accum_steps > 1:
        raise NotImplementedError(
            "grad_accum_steps > 1 is not ported yet (ROADMAP.md queue A, item 1)")
    if cfg.quantizer.type == "entropy":
        raise NotImplementedError(
            "the entropy quantizer is not ported yet (ROADMAP.md queue A, item 6)")
    if cfg.use_adversarial and cfg.loss.adversarial.use_adaptive:
        raise NotImplementedError(
            "use_adaptive: true (adaptive lambda) is not ported yet (ROADMAP.md queue A, item 2)")
    if cfg.loss is not None and not cfg.use_adversarial and cfg.loss.perc_weight != 0.0:
        raise NotImplementedError(
            "a loss: block without adversarial_params takes LPIPS-AlexNet, which is not "
            "ported yet (ROADMAP.md queue A, item 9)")


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
    # LPIPS weights as a JAX-layout tree (the JAX Trainer's lpips_params);
    # None = the converted .npz if present, else seeded random weights
    lpips_params_override: Optional[dict] = None
    # extra Discriminator arguments (e.g. a smaller channel_base in tests)
    disc_kwargs: Optional[dict] = None
    fused_dbwd: bool = False
    fused_skip: bool = False

    def __post_init__(self):
        cfg = self.cfg
        t = cfg.training
        _refuse_unported(cfg)
        self.device = torch.device(self.device)
        self.lr_sched = build_lr_schedule(self.learning_rate, self.steps_per_epoch,
                                          t.warmup_epochs, t.decay_epochs)
        self.temp_sched = self.kl_sched = None
        if cfg.quantizer.type == "gumbel":
            p = cfg.quantizer.params
            self.temp_sched, self.kl_sched = build_gumbel_schedules(
                float(p["temp"]), float(p["kl_cost"]), self.steps_per_epoch,
                p.get("kl_warmup_epochs"), p.get("temp_decay_epochs"), p.get("temp_final"))
        self.losses = None
        self.d_offset = 0
        if cfg.loss is not None:
            lpips = None
            # perc_weight 0 elides the backbone (its term is exactly p * 0);
            # not under use_adaptive, whose lambda takes the unweighted LPIPS
            if cfg.loss.perc_weight != 0.0 or (cfg.use_adversarial
                                               and cfg.loss.adversarial.use_adaptive):
                lpips = init_lpips("vgg", seed=self.seed, dtype=self.compute_dtype,
                                   device=self.device, params=self.lpips_params_override)
            self.losses = steps.LossStack(cfg.loss.l1_weight, cfg.loss.l2_weight,
                                          cfg.loss.perc_weight, lpips, cfg.loss.adversarial)
            if cfg.use_adversarial:
                self.d_offset = int(cfg.loss.adversarial.start_epoch) * self.steps_per_epoch
        self.host_step = 0

    def init_state(self) -> TrainState:
        """A fresh state: the model's weights drawn from ``seed`` and the
        discriminator's from ``seed + 1`` (the same on every device), fresh
        optimizers, the augmentation generator and the gumbel noise generator
        seeded from ``seed``, and zero usage."""
        cfg = self.cfg
        t = cfg.training
        model = VQVAE.from_config(cfg, dtype=self.compute_dtype, device=self.device,
                                  generator=torch.Generator().manual_seed(self.seed))
        model.train()
        state = TrainState(
            step=0, model=model,
            optimizer=make_ae_optimizer(model, t.betas, t.eps, t.weight_decay),
            generator=torch.Generator().manual_seed(self.seed),
            usage_count=torch.zeros(cfg.quantizer.num_embeddings, dtype=torch.int32,
                                    device=self.device))
        if cfg.quantizer.type == "gumbel":
            state.noise_generator = torch.Generator(device=self.device).manual_seed(self.seed)
        if cfg.use_adversarial:
            state.disc = Discriminator(cfg.image_size, dtype=self.compute_dtype,
                                       fused_dbwd=self.fused_dbwd, fused_skip=self.fused_skip,
                                       seed=self.seed + 1, device=self.device,
                                       **(self.disc_kwargs or {}))
            state.disc_optimizer = make_disc_optimizer(state.disc, t.betas, t.eps,
                                                       t.weight_decay)
        return state

    def gan_active(self, epoch: int) -> bool:
        return self.cfg.use_adversarial and epoch >= self.cfg.loss.adversarial.start_epoch

    def sync_host_step(self, state: TrainState) -> None:
        """Align the host step counter with a (restored) state."""
        self.host_step = state.step

    def _images(self, batch) -> torch.Tensor:
        return torch.as_tensor(batch["image"], device=self.device)

    def _gumbel(self, step: int):
        if self.temp_sched is None:
            return None, None
        return self.temp_sched(step), self.kl_sched(step)

    def train_step(self, state: TrainState, batch, epoch: int):
        """-> (state, metrics); ``batch["image"]`` is a [0,1] float or uint8
        NHWC batch. The state is updated in place and returned."""
        gan = self.gan_active(epoch)
        adv = self.cfg.loss.adversarial if gan else None
        r1 = (gan and adv.r1_reg_weight is not None
              and self.host_step % adv.r1_reg_every == 0)
        self.host_step += 1
        temp, kl_cost = self._gumbel(state.step)
        metrics = steps.train_step(
            state, self._images(batch), self.lr_sched(state.step), self.augment,
            self.cfg.image_size, losses=self.losses, gan=gan, r1=r1,
            d_lr=self.lr_sched(state.disc_step + self.d_offset) if gan else None,
            temp=temp, kl_cost=kl_cost)
        return state, metrics

    def eval_step(self, state: TrainState, batch, epoch: int):
        """-> (metrics, usage, reconstructions); ``batch["mask"]`` (B,) bool
        marks the valid rows (all of them when absent). The gumbel noise of
        an eval step comes from a generator seeded by (seed, step), so that
        evaluating leaves the training noise alone."""
        images = self._images(batch)
        mask = batch.get("mask")
        mask = (torch.ones(images.shape[0], dtype=torch.bool, device=self.device)
                if mask is None else torch.as_tensor(mask, device=self.device))
        temp, kl_cost = self._gumbel(state.step)
        generator = None
        if temp is not None:
            generator = torch.Generator(device=self.device).manual_seed(
                (self.seed << 32) + state.step)
        return steps.eval_step(state, images, mask, losses=self.losses,
                               gan=self.gan_active(epoch), temp=temp, kl_cost=kl_cost,
                               generator=generator)

    def reset_usage(self, state: TrainState) -> TrainState:
        state.usage_count.zero_()
        return state
