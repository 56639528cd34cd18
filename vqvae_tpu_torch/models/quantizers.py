"""Standard vector quantizer and codebook helpers (counterpart of
``vqvae_tpu/models/quantizers.py:44-93, 166-213``).

Quantizers take NCHW latents ``z: (B, D, H, W)`` and flatten them in
(b, h, w) row-major order, as the JAX package flattens its NHWC latents, so
codes ``(B, H*W)`` mean the same positions on both sides.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vqvae_tpu_torch.ops.vq import nearest_codes


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

    def forward(self, z: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """NCHW latents -> (quantized NCHW, codes (B, H*W) int32, loss)."""
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


def make_quantizer(q_type: str, num_embeddings: int, embedding_dim: int,
                   params: dict, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Quantizer factory (reference model.py:89-124); this slice ports the
    standard quantizer only."""
    if q_type == "standard":
        return VectorQuantizer(num_embeddings, embedding_dim,
                               commitment_cost=float(params["commitment_cost"]),
                               generator=generator)
    if q_type == "ema":
        raise NotImplementedError(
            "the ema quantizer is not ported yet (ROADMAP.md queue A, item 8, "
            "with kernel B2)")
    if q_type in ("gumbel", "entropy"):
        raise NotImplementedError(
            f"the {q_type} quantizer is not ported yet (ROADMAP.md queue A, item 9)")
    raise ValueError(f"unrecognized quantizer: {q_type}")
