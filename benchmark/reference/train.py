"""The plain reference of a training run's first steps, and of the two
serving paths (encoder to codes; codes to images).

``Run`` follows the port's training step as the published recipe defines it:
the augmentation, the discriminator's real half with the R1 penalty on the
steps that take it (``autograd.grad`` with ``create_graph``), the
autoencoder's forward, L1 / L2 / LPIPS, the generator and fake halves on one
discriminator forward, and AdamW (decoupled weight decay) on both models.
It reads what the comparison needs: each step's losses, the first step's
gradient norm of every leaf, every leaf's change after the last step, and
how many latent rows took a code.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark import reference
from benchmark.reference import nets
from benchmark.reference.disc import LPIPS, Discriminator


def _split(weights: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)}


def build(cfg: dict, weights: dict, device) -> dict:
    """The reference's modules with the benchmark's weights: {"model": the
    configuration's reference ``VQVAE``, and with a GAN "disc" and
    "lpips"}."""
    parts = {"model": reference.of(cfg).VQVAE(cfg)}
    adv = (cfg.get("loss") or {}).get("adversarial_params")
    if adv is not None:
        parts["disc"] = Discriminator(cfg["image_size"], **cfg.get("discriminator", {}))
        parts["lpips"] = LPIPS()
    for name, module in parts.items():
        module.to(device)
        module.load_state_dict({k: v.clone() for k, v in _split(weights, name + ".").items()},
                               strict=True)
    return parts


def spec_modules(cfg: dict) -> dict:
    """The reference's modules on the meta device: names and shapes of every
    leaf the benchmark makes weights for."""
    with torch.device("meta"):
        parts = {"model": reference.of(cfg).VQVAE(cfg)}
        if (cfg.get("loss") or {}).get("adversarial_params") is not None:
            parts["disc"] = Discriminator(cfg["image_size"], **cfg.get("discriminator", {}))
            parts["lpips"] = LPIPS()
    return parts


class AdamW:
    """torch.optim.AdamW's arithmetic, one leaf at a time."""

    def __init__(self, params: dict, decay: set, betas, eps: float, weight_decay: float):
        self.params, self.decay = params, decay
        self.b1, self.b2 = betas
        self.eps, self.wd = eps, weight_decay
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, lr: float):
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = p.grad
            if k in self.decay:
                p.mul_(1 - lr * self.wd)
            self.m[k].lerp_(g, 1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-lr / bc1)
            p.grad = None


class Run:
    """The first steps of training from the benchmark's weights.

    ``seed`` seeds the augmentation (on the CPU) and the gumbel noise (on
    ``device``) as the port's Trainer seeds them for rank 0; ``step`` and
    ``disc_step`` are the global step counts the run starts from;
    ``spe`` the steps per epoch of the schedules; ``epoch`` decides whether
    the GAN is active; ``r1`` (a function of the step index) whether a step
    takes the R1 penalty."""

    def __init__(self, cfg: dict, weights: dict, seed: int, step: int, disc_step: int,
                 spe: int, epoch: int, r1, device, half_batch: bool = False):
        arch = reference.of(cfg)
        if not hasattr(arch, "decay_names"):
            raise ValueError(f"{arch.__name__} has no training reference (no decay_names): "
                             "a training cell needs one")
        self.cfg, self.device = cfg, device
        # on the meta device (``weights`` None) the run only traces its
        # operations, for the FLOP count: nothing is read back
        self.meta = weights is None
        self.parts = spec_modules(cfg) if self.meta else build(cfg, weights, device)
        self.initial = weights
        t = cfg["training"]
        lr = t["base_lr"] * math.sqrt(t["cumulative_bs"] / 256)
        self.lr = nets.lr_schedule(lr, spe, t.get("warmup_epochs"), t.get("decay_epochs"))
        q = cfg["quantizer"]
        self.temp = self.kl = None
        if q["type"] == "gumbel":
            self.temp, self.kl = nets.gumbel_schedules(q["params"], spe)
        self.loss = cfg.get("loss")
        self.adv = (self.loss or {}).get("adversarial_params")
        self.gan = self.adv is not None and epoch >= self.adv["start_epoch"]
        self.d_offset = self.adv["start_epoch"] * spe if self.adv else 0
        self.step_count, self.disc_step, self.r1 = step, disc_step, r1
        self.aug = torch.Generator().manual_seed(seed)
        self.noise = None if self.meta else torch.Generator(device=device).manual_seed(seed)
        self.half_batch = half_batch
        betas, eps, wd = tuple(t["betas"]), t["eps"], t["weight_decay"]
        model = self.parts["model"]
        self.leaves = {f"model.{k}": p for k, p in model.named_parameters()}
        self.opt = AdamW(dict(self.leaves), arch.decay_names(model, "model."), betas, eps, wd)
        if self.gan:
            disc = self.parts["disc"]
            d_leaves = {f"disc.{k}": p for k, p in disc.named_parameters()}
            self.d_opt = AdamW(d_leaves, set(d_leaves), betas, eps, wd)
            self.leaves.update(d_leaves)
        self.first_grads = None
        self.usage_total = 0    # latent rows given a code, over the steps
        self.index = 0

    def _states(self) -> dict:
        """Every leaf a step changes: parameters, and the EMA buffers."""
        out = dict(self.leaves)
        for k, b in self.parts["model"].named_buffers():
            out[f"model.{k}"] = b
        return out

    def step(self, raw_u8: torch.Tensor) -> dict:
        """One optimizer step (two with the GAN) on a uint8 NHWC batch ->
        its losses as floats."""
        model = self.parts["model"]
        size = self.cfg["image_size"]
        images = nets.augment(raw_u8.to(self.device), self.aug, size)
        if self.half_batch:   # a fault: the mean taken over half the batch
            images = images[: images.shape[0] // 2]
        out = {}
        if self.gan:
            disc, r1 = self.parts["disc"], self.r1(self.index)
            d_params = list(disc.parameters())
            real = images.permute(0, 3, 1, 2).detach().requires_grad_(r1)
            logits = disc(real)
            d_real = F.softplus(-logits).mean()
            penalty = torch.zeros((), device=self.device)
            if r1:
                (grad,) = torch.autograd.grad(logits.sum(), real, create_graph=True)
                penalty = self.adv["r1_reg_weight"] * grad.square().flatten(1).sum(1).mean()
            (d_real + penalty).backward(inputs=d_params)
            out["r1_penalty"] = penalty
            del logits, real
        qargs = {}
        if self.temp is not None:
            qargs = {"temp": self.temp(self.step_count), "kl_cost": self.kl(self.step_count),
                     "generator": self.noise}
        recon, q_loss, codes = model(images, train=True, **qargs)
        self.usage_total += codes.numel()
        l1 = (images - recon).abs().mean()
        l2 = (images - recon).square().mean()
        ae_params = [p for k, p in self.leaves.items() if k.startswith("model.")]
        if self.loss is None:
            loss = q_loss + l2
            loss.backward(inputs=ae_params)
        else:
            perc = self.parts["lpips"](images, recon) if "lpips" in self.parts else 0.0
            nll = l1 * self.loss["l1_weight"] + l2 * self.loss["l2_weight"] + \
                perc * self.loss["perc_weight"]
            if self.gan:
                logits_fake = disc(recon.permute(0, 3, 1, 2))
                loss = nll + F.softplus(-logits_fake).mean() * self.adv["g_weight"] + q_loss
                d_fake = F.softplus(logits_fake).mean()
                out["disc_loss"] = d_real + d_fake
                d_fake.backward(inputs=d_params, retain_graph=True)
            else:
                loss = nll + q_loss
            loss.backward(inputs=ae_params)
        out.update(loss=loss, quant_loss=q_loss, l1_loss=l1, l2_loss=l2)
        if self.meta:
            return out
        if self.first_grads is None:
            self.first_grads = {k: float(torch.linalg.vector_norm(p.grad.double()))
                                for k, p in self.leaves.items()}
        lr = self.lr(self.step_count)
        self.opt.step(lr)
        if self.gan:
            self.d_opt.step(self.lr(self.disc_step + self.d_offset))
            self.disc_step += 1
        self.step_count += 1
        self.index += 1
        return {k: float(v.detach()) for k, v in out.items()}

    def changes(self) -> dict:
        """Every leaf's norm of (now - initial)."""
        return {k: float(torch.linalg.vector_norm((v.detach() - self.initial[k]).double()))
                for k, v in self._states().items()}


@torch.no_grad()
def encode_latents(cfg: dict, weights: dict, images_u8: torch.Tensor, block: int = 32):
    """uint8 NHWC images -> the encoder's flattened latents (M, C), in
    blocks of ``block`` images."""
    model = build(cfg, weights, images_u8.device)["model"]
    out = []
    for lo in range(0, images_u8.shape[0], block):
        z = model.encoder(nets.normalize(images_u8[lo:lo + block]).permute(0, 3, 1, 2))
        out.append(z.permute(0, 2, 3, 1).reshape(-1, z.shape[1]))
    return torch.cat(out)


@torch.no_grad()
def decode_tokens(cfg: dict, weights: dict, tokens: torch.Tensor, block: int = 32):
    """(B, S) tokens -> NHWC images in [0, 1], float32, in blocks."""
    model = build(cfg, weights, tokens.device)["model"]
    return torch.cat([model.decode_tokens(tokens[lo:lo + block])
                      for lo in range(0, tokens.shape[0], block)])
