"""Standard, EMA, gumbel and entropy vector quantizers and codebook helpers,
dead-code reinit among them (counterpart of ``vqvae_tpu/models/quantizers.py``).

Quantizers take NCHW latents ``z: (B, D, H, W)`` and flatten them in
(b, h, w) row-major order, as the JAX package flattens its NHWC latents, so
codes ``(B, H*W)`` mean the same positions on both sides.
"""

from __future__ import annotations

from typing import Optional, Tuple

import math

import torch
import torch.nn.functional as F
from torch import nn

from vqvae_tpu_torch.models.preprocess import to_nchw, to_nhwc
from vqvae_tpu_torch.ops.vq import nearest_codes, nearest_codes_stats
from vqvae_tpu_torch.parallel.dist import all_reduce_sum_
from vqvae_tpu_torch.utils.precision import full_fp32


def codebook_init(num_embeddings: int, embedding_dim: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """U(+-1/num_embeddings) fp32 (reference base_quantizer.py:27-31)."""
    bound = 1.0 / num_embeddings
    return torch.empty(num_embeddings, embedding_dim).uniform_(
        -bound, bound, generator=generator)


def _flatten(z: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int, int, int]]:
    b, d, h, w = z.shape
    return to_nhwc(z).reshape(b * h * w, d), (b, h, w, d)


def _row_weights(mask: Optional[torch.Tensor], hw: int) -> Optional[torch.Tensor]:
    """(B,) bool sample mask -> (B*hw,) float row weights, or None."""
    if mask is None:
        return None
    return mask.float().repeat_interleave(hw)


def _wmean(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of x; with (M,) row weights, the mean over nonzero-weight rows."""
    if w is None:
        return x.mean()
    wb = w.reshape((-1,) + (1,) * (x.dim() - 1))
    denom = w.sum() * (x.numel() // x.shape[0])
    return (x * wb).sum() / torch.clamp(denom, min=1.0)


def codes_to_vec(codebook: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Lookup codes (B, S) -> (B, S, D) (reference base_quantizer.py:53-61)."""
    return torch.index_select(codebook, 0, codes.reshape(-1)).reshape(
        *codes.shape, codebook.shape[1])


def get_codebook_usage(index_count: torch.Tensor):
    """(probs, perplexity, %used) from per-code usage counts
    (reference base_quantizer.py:63-79); an all-zero histogram gives
    perplexity 1 and usage 0."""
    index_count = index_count.float()
    probs = index_count / torch.clamp(index_count.sum(), min=1.0)
    perplexity = torch.exp(-(probs * torch.log(probs + 1e-10)).sum())
    used_pct = torch.count_nonzero(probs) * 100.0 / index_count.shape[0]
    return probs, perplexity, used_pct


def pick_reinit(usage_probs: torch.Tensor, embedding_dim: int, generator: torch.Generator,
                noise_scale: float = 0.0):
    """The pick half of dead-code reinit: one replacement index per code,
    drawn with replacement from the usage distribution (so only used codes),
    and, with ``noise_scale``, standard normal noise for each row; both drawn
    on the CPU from ``generator`` and moved to ``usage_probs``' device.
    -> (replacements (N,) int64, noise (N, D) fp32 or None)."""
    n = usage_probs.shape[0]
    weights = usage_probs.detach().double().cpu()
    if not bool((weights > 0).any()):
        weights = torch.ones(n, dtype=torch.float64)   # nothing used: uniform
    replacements = torch.multinomial(weights, n, replacement=True, generator=generator)
    noise = None
    if noise_scale:
        noise = torch.randn(n, embedding_dim, generator=generator).to(usage_probs.device)
    return replacements.to(usage_probs.device), noise


def _reinit_rows(codebook, usage_probs, replacements, noise, noise_scale):
    unused = usage_probs == 0.0
    rows = codebook[replacements]
    if noise_scale:
        std = codebook.std(0, correction=0, keepdim=True)
        rows = rows + noise_scale * std * noise
    return unused, rows


def reinit_unused_codes(codebook: torch.Tensor, usage_probs: torch.Tensor,
                        replacements: torch.Tensor, noise: Optional[torch.Tensor] = None,
                        noise_scale: float = 0.0) -> torch.Tensor:
    """The apply half of dead-code reinit (counterpart of
    ``vqvae_tpu/models/quantizers.py:96-125``): each unused row (usage 0)
    becomes its replacement's row, perturbed by ``noise_scale`` times the
    per-dimension codebook std times ``noise`` where ``noise_scale > 0``.
    Returns the new codebook."""
    unused, rows = _reinit_rows(codebook, usage_probs, replacements, noise, noise_scale)
    return torch.where(unused[:, None], rows, codebook)


def reinit_unused_codes_ema(codebook: torch.Tensor, ema_weight: torch.Tensor,
                            ema_count: torch.Tensor, usage_probs: torch.Tensor,
                            replacements: torch.Tensor, noise: Optional[torch.Tensor] = None,
                            noise_scale: float = 0.0):
    """The apply half for the EMA quantizer (counterpart of
    ``vqvae_tpu/models/quantizers.py:128-164``): the unused rows' EMA
    accumulators are resampled too, so that the next step's
    ``ema_weight / ema_count`` keeps the new row (the reference rewrites the
    codebook alone, which the next step undoes; the JAX package's fix).
    Returns (codebook, ema_weight, ema_count)."""
    unused, rows = _reinit_rows(codebook, usage_probs, replacements, noise, noise_scale)
    new_count = torch.where(unused, ema_count[replacements], ema_count)
    new_cb = torch.where(unused[:, None], rows, codebook)
    new_weight = torch.where(unused[:, None], rows * new_count[:, None], ema_weight)
    return new_cb, new_weight, new_count


def count_code_usage(codes: torch.Tensor, num_embeddings: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(num_embeddings,) int32 histogram of codes (B, S); rows with
    ``mask=False`` are left out."""
    codes = codes.long()
    if mask is not None:
        # masked rows land in an extra bin that is dropped
        codes = codes.masked_fill(~mask.bool()[:, None], num_embeddings)
    counts = torch.bincount(codes.reshape(-1), minlength=num_embeddings + 1)
    return counts[:num_embeddings].int()


class VectorQuantizer(nn.Module):
    """Standard VQ with the straight-through estimator
    (reference vector_quantizers.py:8-84)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 commitment_cost: float = 0.25,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.commitment_cost = commitment_cost
        self.codebook = nn.Embedding(
            num_embeddings, embedding_dim,
            _weight=codebook_init(num_embeddings, embedding_dim, generator))

    def forward(self, z: torch.Tensor, train: bool = False,
                mask: Optional[torch.Tensor] = None):
        """NCHW latents -> (quantized NCHW, codes (B, H*W) int32, loss);
        ``train`` changes nothing here (the codebook trains by gradient)."""
        codebook = self.codebook.weight
        flat_x, (b, h, w, d) = _flatten(z)
        rw = _row_weights(mask, h * w)

        codes = nearest_codes(flat_x, codebook)
        quantized = torch.index_select(codebook, 0, codes)

        e_loss = self.commitment_cost * _wmean((quantized.detach() - flat_x) ** 2, rw)
        q_loss = _wmean((quantized - flat_x.detach()) ** 2, rw)

        quantized = flat_x + (quantized - flat_x).detach()
        quantized = to_nchw(quantized.reshape(b, h, w, d))
        return quantized, codes.reshape(b, h * w), q_loss + e_loss

    def vec_to_codes(self, z: torch.Tensor) -> torch.Tensor:
        """NCHW latents -> (B, H*W) int32 codes."""
        flat_x, (b, h, w, d) = _flatten(z)
        return nearest_codes(flat_x, self.codebook.weight).reshape(b, h * w)


class EMAVectorQuantizer(nn.Module):
    """EMA-codebook VQ (counterpart of ``vqvae_tpu/models/quantizers.py:216-296``,
    reference vector_quantizers.py:87-203).

    The codebook and the EMA accumulators are buffers, never parameters, under
    the reference's names (``codebook.weight``, ``ema_count``, ``ema_weight``)
    so that ``vqvae_tpu/utils/torch_convert.py`` maps them. They move only in a
    ``forward(..., train=True)``, never on ``nn.Module.training``, so the
    tokenizer API leaves them alone in any mode. The lookup reads the codebook
    from before the update. The Laplace smoothing is normalized by the image
    count ``b``, not the latent count ``b*h*w``, a reference quirk kept for
    training parity. Under a process group the counts, the sums and the image
    count are summed over the ranks before the update (once per micro-batch),
    so every replica applies the global batch's update.
    """

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 commitment_cost: float = 0.25, decay: float = 0.95,
                 epsilon: float = 1e-5, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.commitment_cost = commitment_cost
        self.decay = decay
        self.epsilon = epsilon
        self.codebook = nn.Module()
        self.codebook.register_buffer(
            "weight", codebook_init(num_embeddings, embedding_dim, generator))
        self.register_buffer("ema_count", torch.zeros(num_embeddings))
        self.register_buffer(
            "ema_weight", codebook_init(num_embeddings, embedding_dim, generator))

    def forward(self, z: torch.Tensor, train: bool = False,
                mask: Optional[torch.Tensor] = None):
        """NCHW latents -> (quantized NCHW, codes (B, H*W) int32, commitment
        loss); ``train=True`` also advances the EMA buffers in place."""
        codebook = self.codebook.weight
        flat_x, (b, h, w, d) = _flatten(z)
        if train:
            codes, counts, dw = nearest_codes_stats(flat_x, codebook)
        else:
            codes = nearest_codes(flat_x, codebook)
        quantized = torch.index_select(codebook, 0, codes)

        if train:
            with torch.no_grad():
                # the global batch's statistics, as every replica applies
                # them (JAX's psum, quantizers.py:268-271); the image count
                # is an fp32 tensor, as the JAX package's
                batch = torch.full((), float(b), device=counts.device)
                all_reduce_sum_([counts, dw, batch])
                ema_count = self.ema_count * self.decay + (1 - self.decay) * counts
                ema_count = ((ema_count + self.epsilon)
                             / (batch + self.num_embeddings * self.epsilon) * batch)
                self.ema_weight.mul_(self.decay).add_((1 - self.decay) * dw)
                self.ema_count.copy_(ema_count)
                codebook.copy_(self.ema_weight / ema_count[:, None])

        e_loss = self.commitment_cost * _wmean((quantized - flat_x) ** 2,
                                               _row_weights(mask, h * w))
        quantized = flat_x + (quantized - flat_x).detach()
        quantized = to_nchw(quantized.reshape(b, h, w, d))
        return quantized, codes.reshape(b, h * w), e_loss

    def vec_to_codes(self, z: torch.Tensor) -> torch.Tensor:
        """NCHW latents -> (B, H*W) int32 codes."""
        flat_x, (b, h, w, d) = _flatten(z)
        return nearest_codes(flat_x, self.codebook.weight).reshape(b, h * w)


def gumbel_noise(shape, device, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(E)``, E ~ Exp(1) (``F.gumbel_softmax``'s
    draw), fp32, from ``generator`` (on ``device``) or the default one."""
    e = torch.empty(shape, device=device).exponential_(generator=generator)
    return -e.log()


def gumbel_softmax(logits: torch.Tensor, tau: float, hard: bool,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Gumbel-softmax over the last dim (``F.gumbel_softmax`` with an
    explicit generator); ``hard``: one-hot of the argmax + soft - soft.detach()."""
    g = gumbel_noise(logits.shape, logits.device, generator).to(logits.dtype)
    y_soft = ((logits + g) / tau).softmax(-1)
    if not hard:
        return y_soft
    idx = y_soft.argmax(-1, keepdim=True)
    y_hard = torch.zeros_like(y_soft).scatter_(-1, idx, 1.0)
    return y_hard + y_soft - y_soft.detach()


class GumbelVectorQuantizer(nn.Module):
    """Gumbel-softmax VQ (counterpart of ``vqvae_tpu/models/quantizers.py:310-381``,
    reference vector_quantizers.py:206-274).

    The encoder emits ``num_embeddings`` channels; ``x_to_logits``, a 1x1
    conv N -> N in fp32 (a full-fp32 matmul, as the JAX einsum at HIGHEST),
    maps them to logits. Training mixes the codebook with the soft one-hot
    (hard only with ``straight_through``); inference takes the hard one-hot.
    The loss is ``kl_cost`` times KL(q || uniform) over the unmasked rows.
    ``temp`` and ``kl_cost`` are call-time arguments (the schedules' values);
    the noise comes from ``generator``.
    """

    def __init__(self, num_embeddings: int, embedding_dim: int, straight_through: bool = False,
                 temp: float = 1.0, kl_cost: float = 5e-4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n = num_embeddings
        self.num_embeddings = n
        self.straight_through = straight_through
        self.temp = temp
        self.kl_cost = kl_cost
        self.codebook = nn.Embedding(n, embedding_dim,
                                     _weight=codebook_init(n, embedding_dim, generator))
        self.x_to_logits = nn.Conv2d(n, n, 1, device="meta")
        bound = 1.0 / math.sqrt(n)   # torch's default conv init, as the JAX package's
        self.x_to_logits.weight = nn.Parameter(
            torch.empty(n, n, 1, 1).uniform_(-bound, bound, generator=generator))
        self.x_to_logits.bias = nn.Parameter(
            torch.empty(n).uniform_(-bound, bound, generator=generator))

    def logits(self, flat_z: torch.Tensor) -> torch.Tensor:
        w = self.x_to_logits.weight[:, :, 0, 0]
        return torch.addmm(self.x_to_logits.bias, flat_z.float(), w.T)

    def forward(self, z: torch.Tensor, train: bool = False, mask: Optional[torch.Tensor] = None,
                temp: Optional[float] = None, kl_cost: Optional[float] = None,
                generator: Optional[torch.Generator] = None):
        """NCHW latents (B, N, H, W) -> (quantized NCHW, codes (B, H*W) int32,
        KL loss)."""
        temp = self.temp if temp is None else temp
        kl_cost = self.kl_cost if kl_cost is None else kl_cost
        flat_z, (b, h, w, n) = _flatten(z)
        logits = self.logits(flat_z)
        hard = self.straight_through if train else True
        soft_one_hot = gumbel_softmax(logits, temp, hard, generator)
        quantized = soft_one_hot @ self.codebook.weight

        qy = logits.softmax(-1)
        kl_per_pos = (qy * torch.log(qy * n + 1e-10)).sum(-1)
        kl_loss = kl_cost * _wmean(kl_per_pos, _row_weights(mask, h * w))

        codes = soft_one_hot.detach().argmax(-1).int().reshape(b, h * w)
        quantized = to_nchw(quantized.reshape(b, h, w, -1))
        return quantized, codes, kl_loss

    def vec_to_codes(self, z: torch.Tensor, deterministic: bool = False,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Codes from raw encoder output (B, N, H, W) -> (B, H*W) int32. As the
        reference, the noise (tau 1, hard) goes on the raw encoder channels,
        not on ``x_to_logits``'s logits; ``deterministic=True`` is the plain
        argmax."""
        flat_z, (b, h, w, n) = _flatten(z)
        if not deterministic:
            flat_z = flat_z + gumbel_noise(flat_z.shape, flat_z.device, generator).to(flat_z.dtype)
        return flat_z.argmax(-1).int().reshape(b, h * w)


class EntropyVectorQuantizer(VectorQuantizer):
    """MaskGIT entropy-regularized VQ (counterpart of
    ``vqvae_tpu/models/quantizers.py:384-428``, reference
    vector_quantizers.py:277-381).

    The entropy loss needs the whole distance matrix
    ``|x|^2 - 2 x c^T + |c|^2``, so the forward pass forms it with one fp32
    matmul, TF32 off (the JAX package's ``Precision.HIGHEST``), and takes its
    codes as the ``argmin`` of that matrix, as JAX does. ``vec_to_codes`` (the
    tokenizer's path) goes through ``nearest_codes``, kernel B1 on the card.
    """

    def __init__(self, num_embeddings: int, embedding_dim: int, ent_loss_ratio: float = 0.1,
                 ent_temperature: float = 0.01, ent_loss_type: str = "softmax",
                 commitment_cost: float = 0.25, generator: Optional[torch.Generator] = None):
        super().__init__(num_embeddings, embedding_dim, commitment_cost, generator)
        self.ent_loss_ratio = ent_loss_ratio
        self.ent_temperature = ent_temperature
        self.ent_loss_type = ent_loss_type

    def forward(self, z: torch.Tensor, train: bool = False,
                mask: Optional[torch.Tensor] = None):
        """NCHW latents -> (quantized NCHW, codes (B, H*W) int32, commitment +
        codebook + entropy loss); ``train`` changes nothing here."""
        codebook = self.codebook.weight
        flat_x, (b, h, w, d) = _flatten(z)
        rw = _row_weights(mask, h * w)

        x2 = (flat_x ** 2).sum(1, keepdim=True)
        c2 = (codebook ** 2).sum(1)[None]
        with full_fp32():
            xc = flat_x @ codebook.T
        distances = x2 - 2 * xc + c2

        codes = distances.detach().argmin(1)
        quantized = torch.index_select(codebook, 0, codes)

        e_loss = self.commitment_cost * _wmean((quantized.detach() - flat_x) ** 2, rw)
        q_loss = _wmean((quantized - flat_x.detach()) ** 2, rw)
        ent = self.ent_loss_ratio * entropy_loss(-distances, self.ent_temperature,
                                                 self.ent_loss_type, row_weights=rw)

        quantized = flat_x + (quantized - flat_x).detach()
        quantized = to_nchw(quantized.reshape(b, h, w, d))
        return quantized, codes.int().reshape(b, h * w), e_loss + q_loss + ent


def entropy_loss(affinity: torch.Tensor, temperature: float, loss_type: str = "softmax",
                 row_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sample_entropy - avg_entropy over temperature-scaled affinities (M, N)
    (counterpart of ``vqvae_tpu/models/quantizers.py:431-464``, reference
    vector_quantizers.py:296-328). ``row_weights`` (M,): masked rows count in
    neither the per-sample entropy's mean nor the batch-average distribution
    (the average couples rows, so the mask has to reach this reduction)."""
    n_classes = affinity.shape[-1]
    affinity = affinity / temperature
    probs = affinity.softmax(-1)

    if loss_type == "softmax":
        target_probs = probs
    elif loss_type == "argmax":
        codes = affinity.argmax(-1)
        one_hots = F.one_hot(codes, n_classes).to(probs.dtype)
        target_probs = probs - (probs - one_hots).detach()
    else:
        raise ValueError(f"Entropy loss {loss_type} not supported")

    if row_weights is None:
        avg_probs = target_probs.mean(0)
    else:
        avg_probs = ((target_probs * row_weights[:, None]).sum(0)
                     / torch.clamp(row_weights.sum(), min=1.0))
    avg_entropy = -(avg_probs * torch.log(avg_probs + 1e-5)).sum()

    log_probs = F.log_softmax(affinity + 1e-5, dim=-1)
    sample_entropy = _wmean(-(target_probs * log_probs).sum(-1), row_weights)
    return sample_entropy - avg_entropy


def make_quantizer(q_type: str, num_embeddings: int, embedding_dim: int,
                   params: dict, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Quantizer factory (reference model.py:89-124)."""
    if q_type == "standard":
        return VectorQuantizer(num_embeddings, embedding_dim,
                               commitment_cost=float(params["commitment_cost"]),
                               generator=generator)
    if q_type == "ema":
        return EMAVectorQuantizer(num_embeddings, embedding_dim,
                                  commitment_cost=float(params["commitment_cost"]),
                                  decay=float(params["decay"]),
                                  epsilon=float(params["epsilon"]),
                                  generator=generator)
    if q_type == "gumbel":
        return GumbelVectorQuantizer(num_embeddings, embedding_dim,
                                     straight_through=bool(params["straight_through"]),
                                     temp=float(params["temp"]),
                                     kl_cost=float(params["kl_cost"]),
                                     generator=generator)
    if q_type == "entropy":
        return EntropyVectorQuantizer(num_embeddings, embedding_dim,
                                      ent_loss_ratio=float(params["ent_loss_ratio"]),
                                      ent_temperature=float(params["ent_temperature"]),
                                      ent_loss_type=str(params["ent_loss_type"]),
                                      commitment_cost=float(params["commitment_cost"]),
                                      generator=generator)
    raise ValueError(f"unrecognized quantizer: {q_type}")
