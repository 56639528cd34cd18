"""The Trainer and the training loop (counterpart of
``vqvae_tpu/train/loop.py``: ``Trainer`` with ``init_state``, ``train_step``,
``eval_step``, ``maybe_reinit_codes``, ``reset_usage``, ``gan_active``,
``sync_host_step``; ``run_training``, ``run_validation``).

The Trainer runs on the card unless ``device="cpu"`` is passed: under a
process group, this rank's ``cuda:LOCAL_RANK`` (``parallel/dist.py``). With a
``loss:`` block it builds the loss stack: LPIPS (VGG with the GAN, AlexNet
without it, as the JAX Trainer picks; elided where ``perc_weight == 0`` and
lambda is not adaptive), the StyleGAN2
discriminator and its optimizer, whose LR schedule is shifted by the
``start_epoch * steps_per_epoch`` steps D sits out. A host step counter
picks the R1 steps (``host_step % r1_reg_every == 0``, counted in optimizer
steps) once the GAN is active. A step takes ``grad_accum_steps``
micro-batches (``train/steps.py``). ``fused_dbwd`` / ``fused_skip`` stand
for the JAX package's ``VQVAE_TPU_FUSED_DBWD`` / ``VQVAE_TPU_FUSED_SKIP``:
the D's first-order backward through the kernels B3 / B4; off by default,
as there. ``native_lr`` is the native LR twin whose value is logged.

``run_training`` is the training protocol of the reference
(train.py:128-142, model.py:163-370): validation every 5 epochs (epoch 0
too), reconstruction panels at batch 2, epoch means of the step metrics
(summed on the device, fetched once per epoch), dead-code reinit every
``reinit_every_n_epochs``, checkpoints every N epochs and ``last``.

Rematerialization (``Trainer.remat``, JAX ``loop.py:98-120``): True
checkpoints every autoencoder ``ResBlock`` and every ``DiscriminatorBlock``;
None (the default) decides from ``estimate_activation_gb`` at
``per_device_batch`` against 75% of ``device_hbm_gb``, or, with the batch
unknown, by ``image_size >= 128``. ``run_training`` passes the per-rank
batch, resets the card's peak memory before the first step and audits the
decision after it (``check_remat_gate``).

Data parallel: every rank builds the same initial state from the seed (the
replicas are checked bitwise after init and after every restore), draws its
augmentations and gumbel noise from its own stream (``rank_seed``; rank 0
keeps the one-process streams), reads its own rows (the loader batch is the
per-rank batch), and takes the step's reductions (``train/steps.py``); the
reinit draws from the same stream on every rank and reads the usage counts
summed over the ranks, so every replica replaces the same rows. Only rank 0
logs, draws panels (from its own rows) and writes checkpoints.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from vqvae_tpu_torch.config import Config
from vqvae_tpu_torch.models.discriminator import Discriminator
from vqvae_tpu_torch.models.lpips import init_lpips
from vqvae_tpu_torch.models.quantizers import (get_codebook_usage, pick_reinit,
                                               reinit_unused_codes, reinit_unused_codes_ema)
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.parallel.dist import default_device, rank_seed, world
from vqvae_tpu_torch.train import steps
from vqvae_tpu_torch.train.native_schedulers import build_native_lr_scheduler
from vqvae_tpu_torch.train.optim import make_ae_optimizer, make_disc_optimizer
from vqvae_tpu_torch.train.schedules import build_gumbel_schedules, build_lr_schedule
from vqvae_tpu_torch.train.state import TrainState
from vqvae_tpu_torch.utils.checkpoint import CheckpointManager
from vqvae_tpu_torch.utils.introspect import check_replication, named_scope
from vqvae_tpu_torch.utils.logging import MetricLogger, make_recon_panel

# Bytes of activations kept per pixel x base channel of a 256^2 GAN train
# step with 2 residual blocks and no remat: the slope of the peak between
# micro-batches 32 and 64 of gumbel_vqgan_1chip.yaml's GAN step in bf16 on an
# H100 (148.7, chip_smoke.py's remat phase), to two figures. The JAX
# package's 40.0 models XLA's buffers on a v5e; eager PyTorch keeps more
# intermediates (a deliberate divergence: the constant models the runtime).
ACTIVATION_BYTES_PER_PIXEL_CHANNEL = 150.0


def fused_backward_from_env() -> dict:
    """The Trainer's ``fused_dbwd`` / ``fused_skip`` from the JAX package's
    switches: ``VQVAE_TPU_FUSED_DBWD`` / ``VQVAE_TPU_FUSED_SKIP`` set to
    ``1``; anything else is off."""
    return {"fused_dbwd": os.environ.get("VQVAE_TPU_FUSED_DBWD", "0") == "1",
            "fused_skip": os.environ.get("VQVAE_TPU_FUSED_SKIP", "0") == "1"}


def device_hbm_gb(device: torch.device) -> float:
    """The memory budget of the auto-remat gate, in GB: the card's total
    memory, or the JAX package's 16 GB fallback when the caller asked for the
    CPU (JAX ``loop.py:50-61``)."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[1] / 1e9
    return 16.0


def memory_peak_and_total(device: torch.device) -> Optional[tuple]:
    """(peak bytes allocated since the last reset, the card's total bytes),
    read after the card's work is done; None off the card (no statistics)."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device), torch.cuda.mem_get_info(device)[1]


def estimate_activation_gb(cfg: Config, per_device_batch: int) -> float:
    """The remat gate's activation-memory model (JAX ``loop.py:64-84``, the
    same formula): ``ACTIVATION_BYTES_PER_PIXEL_CHANNEL`` x pixels x base
    channels x (residual blocks / 2) per image, x 0.5 without a loss stack,
    x 0.75 without a GAN, times the micro-batch. Coarse by design: it only
    picks a side of 75% of the card's memory."""
    c = cfg.autoencoder.channels
    nrb = max(1, cfg.autoencoder.num_res_blocks)
    per_img = ACTIVATION_BYTES_PER_PIXEL_CHANNEL * (cfg.image_size ** 2) * c * (nrb / 2.0)
    if cfg.loss is None:
        per_img *= 0.5
    elif not cfg.use_adversarial:
        per_img *= 0.75
    micro = per_device_batch
    if cfg.training is not None:
        micro = max(1, per_device_batch // cfg.training.grad_accum_steps)
    return micro * per_img / 1e9


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
    # "cuda" without an index is this rank's card: cuda:LOCAL_RANK under a
    # process group
    device: Union[str, torch.device] = "cuda"
    # LPIPS weights as a JAX-layout tree (the JAX Trainer's lpips_params);
    # None = the converted .npz if present, else seeded random weights
    lpips_params_override: Optional[dict] = None
    # extra Discriminator arguments (e.g. a smaller channel_base in tests)
    disc_kwargs: Optional[dict] = None
    fused_dbwd: bool = False
    fused_skip: bool = False
    # None = auto: rematerialize only when the estimated activations would
    # crowd the card's memory; True / False: the caller's decision
    remat: Optional[bool] = None
    per_device_batch: Optional[int] = None  # feeds the auto-remat estimate

    def __post_init__(self):
        cfg = self.cfg
        t = cfg.training
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = default_device()
        self._remat_auto = self.remat is None
        if self.remat is None:
            if self.per_device_batch is not None:
                self.remat = (estimate_activation_gb(cfg, self.per_device_batch)
                              > 0.75 * device_hbm_gb(self.device))
            else:
                # the batch unknown: the JAX package's rule
                self.remat = cfg.image_size >= 128
        self.rank = world()[0]
        self.accum = int(t.grad_accum_steps)
        self.lr_sched = build_lr_schedule(self.learning_rate, self.steps_per_epoch,
                                          t.warmup_epochs, t.decay_epochs)
        # the host-side LR of record (reference model.py:163-187, 305-307)
        self.native_lr = build_native_lr_scheduler(self.learning_rate, self.steps_per_epoch,
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
                lpips = init_lpips("vgg" if cfg.use_adversarial else "alex", seed=self.seed,
                                   dtype=self.compute_dtype, device=self.device,
                                   params=self.lpips_params_override)
            self.losses = steps.LossStack(cfg.loss.l1_weight, cfg.loss.l2_weight,
                                          cfg.loss.perc_weight, lpips, cfg.loss.adversarial)
            if cfg.use_adversarial:
                self.d_offset = int(cfg.loss.adversarial.start_epoch) * self.steps_per_epoch
        self.host_step = 0

    def init_state(self) -> TrainState:
        """A fresh state: the model's weights drawn from ``seed`` and the
        discriminator's from ``seed + 1`` (the same on every rank), fresh
        optimizers, the augmentation generator and the gumbel noise generator
        seeded from ``rank_seed(seed, rank)``, and zero usage."""
        cfg = self.cfg
        t = cfg.training
        model = VQVAE.from_config(cfg, dtype=self.compute_dtype, device=self.device,
                                  generator=torch.Generator().manual_seed(self.seed),
                                  remat=self.remat)
        model.train()
        state = TrainState(
            step=0, model=model,
            optimizer=make_ae_optimizer(model, t.betas, t.eps, t.weight_decay),
            generator=torch.Generator().manual_seed(rank_seed(self.seed, self.rank)),
            usage_count=torch.zeros(cfg.quantizer.num_embeddings, dtype=torch.int32,
                                    device=self.device))
        if cfg.quantizer.type == "gumbel":
            state.noise_generator = torch.Generator(device=self.device).manual_seed(
                rank_seed(self.seed, self.rank))
        if cfg.use_adversarial:
            state.disc = Discriminator(cfg.image_size, dtype=self.compute_dtype,
                                       fused_dbwd=self.fused_dbwd, fused_skip=self.fused_skip,
                                       seed=self.seed + 1, device=self.device,
                                       remat=self.remat, **(self.disc_kwargs or {}))
            state.disc_optimizer = make_disc_optimizer(state.disc, t.betas, t.eps,
                                                       t.weight_decay)
        return state

    def gan_active(self, epoch: int) -> bool:
        return self.cfg.use_adversarial and epoch >= self.cfg.loss.adversarial.start_epoch

    def r1_due(self, epoch: int) -> bool:
        """Whether the next ``train_step`` at ``epoch`` takes the R1 penalty."""
        if not self.gan_active(epoch):
            return False
        adv = self.cfg.loss.adversarial
        return adv.r1_reg_weight is not None and self.host_step % adv.r1_reg_every == 0

    def sync_host_step(self, state: TrainState) -> None:
        """Align the host step counter with a (restored) state."""
        self.host_step = state.step

    def _images(self, batch) -> torch.Tensor:
        """The batch's images on the device; a host array bound for the card
        goes through pinned memory, copied without blocking the host."""
        images = batch["image"]
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        if images.device.type == "cpu" and self.device.type == "cuda":
            return images.pin_memory().to(self.device, non_blocking=True)
        return images.to(self.device)

    def _gumbel(self, step: int):
        if self.temp_sched is None:
            return None, None
        return self.temp_sched(step), self.kl_sched(step)

    def train_step(self, state: TrainState, batch, epoch: int):
        """-> (state, metrics); ``batch["image"]`` is a [0,1] float or uint8
        NHWC batch. The state is updated in place and returned."""
        gan = self.gan_active(epoch)
        r1 = self.r1_due(epoch)
        with named_scope("train.step", step=state.step, r1=r1, images=len(batch["image"])):
            self.host_step += 1
            temp, kl_cost = self._gumbel(state.step)
            metrics = steps.train_step(
                state, self._images(batch), self.lr_sched(state.step), self.augment,
                self.cfg.image_size, losses=self.losses, gan=gan, r1=r1,
                d_lr=self.lr_sched(state.disc_step + self.d_offset) if gan else None,
                temp=temp, kl_cost=kl_cost, accum=self.accum)
        return state, metrics

    def eval_step(self, state: TrainState, batch, epoch: int):
        """-> (metrics, usage, reconstructions); ``batch["mask"]`` (B,) bool
        marks the valid rows (all of them when absent). The gumbel noise of
        an eval step comes from a generator seeded by (seed, step, rank), so
        that evaluating leaves the training noise alone."""
        images = self._images(batch)
        mask = batch.get("mask")
        mask = (torch.ones(images.shape[0], dtype=torch.bool, device=self.device)
                if mask is None else torch.as_tensor(mask, device=self.device))
        temp, kl_cost = self._gumbel(state.step)
        generator = None
        if temp is not None:
            generator = torch.Generator(device=self.device).manual_seed(
                rank_seed((self.seed << 32) + state.step, self.rank))
        return steps.eval_step(state, images, mask, losses=self.losses,
                               gan=self.gan_active(epoch), temp=temp, kl_cost=kl_cost,
                               generator=generator)

    def maybe_reinit_codes(self, state: TrainState, epoch: int) -> TrainState:
        """Dead-code reinit at the end of an epoch (reference model.py:297-303;
        ``vqvae_tpu/train/loop.py:287-314``): every ``reinit_every_n_epochs``
        epochs but epoch 0, each code unused over the epoch takes a used
        code's row, drawn from the usage distribution by a generator seeded
        from (seed, 7919 + epoch), perturbed by ``reinit_noise_scale`` (0 by
        default). The EMA quantizer's accumulators follow its codebook. The
        generator and the usage counts (summed over the ranks by every step)
        are the same on every rank, and so are the picks."""
        every = self.cfg.quantizer.reinit_every_n_epochs
        if every is None or epoch == 0 or epoch % every != 0:
            return state
        probs, _, _ = get_codebook_usage(state.usage_count)
        noise_scale = float(self.cfg.quantizer.params.get("reinit_noise_scale", 0.0))
        q = state.model.quantizer
        codebook = q.codebook.weight
        generator = torch.Generator().manual_seed((self.seed << 32) + 7919 + epoch)
        replacements, noise = pick_reinit(probs, codebook.shape[1], generator, noise_scale)
        with torch.no_grad():
            if self.cfg.quantizer.type == "ema":
                new_cb, new_w, new_c = reinit_unused_codes_ema(
                    codebook, q.ema_weight, q.ema_count, probs, replacements, noise, noise_scale)
                q.ema_weight.copy_(new_w)
                q.ema_count.copy_(new_c)
            else:
                new_cb = reinit_unused_codes(codebook, probs, replacements, noise, noise_scale)
            codebook.copy_(new_cb)
        return state

    def reset_usage(self, state: TrainState) -> TrainState:
        state.usage_count.zero_()
        return state

    def check_remat_gate(self, verbose: bool = True) -> Optional[str]:
        """Audit the auto-remat decision against the card's peak memory since
        the last reset (call once, after the first train step; JAX
        ``loop.py:319-355``, the same thresholds and messages). Silent for a
        decision the caller made, and off the card. Returns the warning
        (also printed) or None when the gate looks right."""
        if not self._remat_auto:
            return None
        read = memory_peak_and_total(self.device)
        if not read or not read[0] or not read[1]:
            return None
        peak, limit = read
        frac = peak / limit
        msg = None
        if not self.remat and frac > 0.92:
            msg = (f"[remat-gate] auto-remat chose OFF but the first step "
                   f"peaked at {peak / 1e9:.2f}/{limit / 1e9:.2f} GB "
                   f"({frac:.0%}) — one allocator hiccup from OOM. Consider "
                   "remat=True (or a smaller per-device batch); "
                   "estimate_activation_gb under-estimated this config.")
        elif self.remat and frac < 0.45:
            msg = (f"[remat-gate] auto-remat chose ON but the first step "
                   f"peaked at only {peak / 1e9:.2f}/{limit / 1e9:.2f} GB "
                   f"({frac:.0%}) — the ~18% recompute tax is likely "
                   "unnecessary. Consider remat=False; "
                   "estimate_activation_gb over-estimated this config.")
        if msg and verbose:
            print(msg)
        return msg


def _to_float01(images) -> np.ndarray:
    """uint8 [0,255] or float [0,1] batch -> float [0,1] on the host (panels)."""
    arr = np.asarray(images)
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    return arr.astype(np.float32)


def _fetch(sums: dict) -> dict:
    """One device-to-host transfer for a dict of 0-d tensors and floats."""
    keys = [k for k, v in sums.items() if isinstance(v, torch.Tensor)]
    values = torch.stack([sums[k].float() for k in keys]).tolist() if keys else []
    return {**{k: float(v) for k, v in sums.items()}, **dict(zip(keys, values))}


def run_training(cfg: Config, train_loader, val_loader, *, seed: int, learning_rate: float,
                 save_dir: str, run_name: str, save_every_n_epochs: int = 1,
                 logger: Optional[MetricLogger] = None, resume_path: Optional[str] = None,
                 compute_dtype: torch.dtype = torch.float32, max_epochs: Optional[int] = None,
                 check_val_every: int = 5, log_recon_batch: int = 2,
                 device: Union[str, torch.device] = "cuda", fused_dbwd: bool = False,
                 fused_skip: bool = False):
    """A whole training run (counterpart of ``vqvae_tpu/train/loop.py:357-403``)
    on ``device``; returns (the final TrainState, the Trainer). The loader
    batch is the per-rank batch (``cumulative_bs`` over the world size under
    a process group): it must divide into ``grad_accum_steps``
    micro-batches, and under a GAN each micro-batch into groups of 4 (the
    D's minibatch-std)."""
    steps_per_epoch = len(train_loader)
    max_epochs = max_epochs or cfg.training.max_epochs
    accum = cfg.training.grad_accum_steps
    per_dev = train_loader.batch_size
    if per_dev % accum != 0:
        raise RuntimeError(
            f"per-device (per-rank) batch {per_dev} must be divisible by "
            f"grad_accum_steps={accum}")
    if cfg.use_adversarial and (per_dev // accum) % 4 != 0:
        raise RuntimeError(
            "batch size per device (per accumulation micro-batch) must be divisible by 4! "
            "(minibatch-std group size in the StyleGAN discriminator)")
    trainer = Trainer(cfg=cfg, learning_rate=learning_rate, seed=seed,
                      steps_per_epoch=steps_per_epoch, compute_dtype=compute_dtype,
                      device=device, fused_dbwd=fused_dbwd, fused_skip=fused_skip,
                      per_device_batch=per_dev)
    try:
        state = _run_epochs(trainer, train_loader, val_loader, save_dir=save_dir,
                            run_name=run_name, save_every_n_epochs=save_every_n_epochs,
                            logger=logger, resume_path=resume_path, max_epochs=max_epochs,
                            check_val_every=check_val_every, log_recon_batch=log_recon_batch)
    finally:
        # the reference's on_train_end (model.py:305-307), on error paths too
        trainer.native_lr.destroy()
    return state, trainer


def _replicas(state: TrainState) -> dict:
    return {"model": state.model, "disc": state.disc, "usage_count": state.usage_count}


def _run_epochs(trainer: Trainer, train_loader, val_loader, *, save_dir, run_name,
                save_every_n_epochs, logger, resume_path, max_epochs, check_val_every,
                log_recon_batch):
    state = trainer.init_state()
    check_replication(_replicas(state))
    ckpt = CheckpointManager(save_dir, run_name, save_every_n_epochs)
    logger = logger or MetricLogger(save_dir, run_name)
    start_epoch = 0
    if resume_path is not None:
        state, start_epoch = ckpt.restore(resume_path, state)
        check_replication(_replicas(state))
        start_epoch += 1
        trainer.sync_host_step(state)
        if trainer.rank == 0:
            print(f"[INFO] resumed from {resume_path} at epoch {start_epoch}")

    if trainer.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(trainer.device)   # the gate reads the first step's
    for epoch in range(start_epoch, max_epochs):
        train_loader.set_epoch(epoch)
        t0 = time.time()
        n_img = n_batches = 0
        sums = None
        for batch_index, batch in enumerate(train_loader):
            state, metrics = trainer.train_step(state, batch, epoch)
            if epoch == start_epoch and batch_index == 0:
                trainer.check_remat_gate()   # waits for the step's work on the card
            n_img += batch["image"].shape[0]
            n_batches += 1
            sums = metrics if sums is None else {k: sums[k] + v for k, v in metrics.items()}
            if batch_index == log_recon_batch and epoch % 5 == 0:
                recons = _eval_batch(trainer, state, batch, epoch, recons=True)[2]
                logger.log_images(make_recon_panel(_to_float01(batch["image"]), recons),
                                  state.step, "train/reconstructions")
        metrics = {k: v / max(n_batches, 1) for k, v in _fetch(sums or {}).items()}
        # the LR of the epoch's last step, from the native twin
        metrics["lr"] = trainer.native_lr.step(max(state.step - 1, 0))
        metrics["images_per_sec"] = n_img / max(time.time() - t0, 1e-9)
        metrics["epoch"] = epoch
        logger.log(metrics, state.step, prefix="train/")

        if epoch % check_val_every == 0 and val_loader is not None:
            val_metrics, usage = run_validation(trainer, state, val_loader, epoch, logger=logger,
                                                log_recon_batch=log_recon_batch)
            _, perplexity, cb_usage = get_codebook_usage(torch.as_tensor(usage))
            logger.log({"used_codebook": float(cb_usage), "perplexity": float(perplexity)},
                       state.step, prefix="val_metrics/")
            logger.log(val_metrics, state.step, prefix="validation/")

        state = trainer.maybe_reinit_codes(state, epoch)
        state = trainer.reset_usage(state)
        ckpt.save(state, epoch)
    return state


def _eval_batch(trainer: Trainer, state: TrainState, batch, epoch: int, recons: bool = False):
    """``eval_step`` on one loader batch, taken in ``grad_accum_steps``
    chunks (at most the training micro-batch's memory): -> (n_valid-weighted
    metric sums and n_valid, usage, and with ``recons`` the [0,1] NHWC
    reconstructions on the host, else None). The weighted sums make the
    masked mean the same number as one call on the whole batch."""
    images = batch["image"]
    mask = batch.get("mask")
    if mask is None:
        mask = np.ones((images.shape[0],), bool)
    chunk = images.shape[0] // trainer.accum
    sums, usage, host = None, None, []
    for lo in range(0, images.shape[0], chunk):
        part = {"image": images[lo:lo + chunk], "mask": mask[lo:lo + chunk]}
        metrics, part_usage, part_recons = trainer.eval_step(state, part, epoch)
        n = metrics.pop("n_valid")
        weighted = {k: v * n for k, v in metrics.items()}
        weighted["n_valid"] = n
        sums = weighted if sums is None else {k: sums[k] + v for k, v in weighted.items()}
        usage = part_usage if usage is None else usage + part_usage
        if recons:
            host.append(part_recons.float().cpu().numpy())
    return sums, usage, np.concatenate(host) if recons else None


def run_validation(trainer: Trainer, state: TrainState, val_loader, epoch: int,
                   logger: Optional[MetricLogger] = None, log_recon_batch: int = 2):
    """The n_valid-weighted mean of every eval metric over the loader, padded
    rows excluded, and the usage counts (counterpart of
    ``vqvae_tpu/train/loop.py:481-514``). -> (metrics, usage (N,) int32)."""
    sums = usage = None
    for batch_index, batch in enumerate(val_loader):
        panel = batch_index == log_recon_batch and logger is not None
        batch_sums, batch_usage, recons = _eval_batch(trainer, state, batch, epoch, panel)
        sums = batch_sums if sums is None else {k: sums[k] + v for k, v in batch_sums.items()}
        usage = batch_usage if usage is None else usage + batch_usage
        if panel:
            logger.log_images(make_recon_panel(_to_float01(batch["image"]), recons),
                              state.step, "validation/reconstructions")
    if sums is None:
        return {}, np.zeros((trainer.cfg.quantizer.num_embeddings,), np.int32)
    sums = _fetch(sums)
    total_n = sums.pop("n_valid")
    return ({k: v / max(total_n, 1.0) for k, v in sums.items()},
            usage.cpu().numpy())
