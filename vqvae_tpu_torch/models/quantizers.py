"""Standard and EMA vector quantizers and codebook helpers (counterpart of
``vqvae_tpu/models/quantizers.py:44-93, 166-296``).

Quantizers take NCHW latents ``z: (B, D, H, W)`` and flatten them in
(b, h, w) row-major order, as the JAX package flattens its NHWC latents, so
codes ``(B, H*W)`` mean the same positions on both sides.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vqvae_tpu_torch.ops.vq import nearest_codes, nearest_codes_stats


def codebook_init(num_embeddings: int, embedding_dim: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """U(+-1/num_embeddings) fp32 (reference base_quantizer.py:27-31)."""
    bound = 1.0 / num_embeddings
    return torch.empty(num_embeddings, embedding_dim).uniform_(
        -bound, bound, generator=generator)


def _flatten(z: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int, int, int]]:
    b, d, h, w = z.shape
    return z.permute(0, 2, 3, 1).reshape(b * h * w, d), (b, h, w, d)


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
        quantized = quantized.reshape(b, h, w, d).permute(0, 3, 1, 2).contiguous()
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
    training parity. Single device: the JAX package's cross-replica ``psum`` of
    the statistics is multi-GPU work (ROADMAP.md queue A, item 13).
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
                ema_count = self.ema_count * self.decay + (1 - self.decay) * counts
                ema_count = ((ema_count + self.epsilon)
                             / (b + self.num_embeddings * self.epsilon) * b)
                self.ema_weight.mul_(self.decay).add_((1 - self.decay) * dw)
                self.ema_count.copy_(ema_count)
                codebook.copy_(self.ema_weight / ema_count[:, None])

        e_loss = self.commitment_cost * _wmean((quantized - flat_x) ** 2,
                                               _row_weights(mask, h * w))
        quantized = flat_x + (quantized - flat_x).detach()
        quantized = quantized.reshape(b, h, w, d).permute(0, 3, 1, 2).contiguous()
        return quantized, codes.reshape(b, h * w), e_loss

    def vec_to_codes(self, z: torch.Tensor) -> torch.Tensor:
        """NCHW latents -> (B, H*W) int32 codes."""
        flat_x, (b, h, w, d) = _flatten(z)
        return nearest_codes(flat_x, self.codebook.weight).reshape(b, h * w)


def make_quantizer(q_type: str, num_embeddings: int, embedding_dim: int,
                   params: dict, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Quantizer factory (reference model.py:89-124); the port carries the
    standard and EMA quantizers."""
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
    if q_type in ("gumbel", "entropy"):
        raise NotImplementedError(
            f"the {q_type} quantizer is not ported yet (ROADMAP.md queue A, item 9)")
    raise ValueError(f"unrecognized quantizer: {q_type}")
