"""The VQ-VAE: encoder -> quantizer -> decoder (counterpart of
``vqvae_tpu/models/vqvae.py:34-158``).

The public methods keep the JAX package's layout: NHWC images in [0,1]
(float or uint8), normalized NHWC images in (-1,1) for ``forward`` /
``encode`` / ``decode``, and int32 tokens (B, H*W) in row-major (h, w)
order. The modules inside run NCHW. The tokenizer API (``get_tokens``,
``quantize``, ``reconstruct``, ``reconstruct_from_tokens``) runs under
``torch.inference_mode()``.

For the gumbel quantizer the encoder emits ``num_embeddings`` channels
(reference model.py:130); ``temp`` and ``kl_cost`` are call-time arguments
(the schedules' values), and ``generator`` draws the gumbel noise.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vqvae_tpu_torch.config import Config
from vqvae_tpu_torch.models.autoencoder import Decoder, Encoder
from vqvae_tpu_torch.models.preprocess import denormalize, preprocess_batch
from vqvae_tpu_torch.models.quantizers import codes_to_vec, make_quantizer


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class VQVAE(nn.Module):
    """Encoder + quantizer + decoder (reference model.py:25-161)."""

    def __init__(self, channels: int, num_res_blocks: int, channel_multipliers,
                 num_embeddings: int, embedding_dim: int, quantizer_type: str,
                 quantizer_params: dict, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.quantizer_type = quantizer_type
        self.quantizer = make_quantizer(quantizer_type, num_embeddings, embedding_dim,
                                        quantizer_params, generator)
        encoder_out = num_embeddings if quantizer_type == "gumbel" else embedding_dim
        self.encoder = Encoder(channels, num_res_blocks, channel_multipliers,
                               encoder_out, dtype, generator)
        self.decoder = Decoder(channels, num_res_blocks, channel_multipliers,
                               embedding_dim, dtype, generator)

    @classmethod
    def from_config(cls, cfg: Config, dtype: torch.dtype = torch.float32,
                    device="cuda", generator: Optional[torch.Generator] = None) -> "VQVAE":
        """Build from a parsed config; parameters are drawn on the CPU from
        ``generator`` (a seed gives the same weights on every device), then
        moved to ``device``, the card unless the caller asks for the CPU.
        Returns the model in eval mode."""
        model = cls(
            channels=cfg.autoencoder.channels,
            num_res_blocks=cfg.autoencoder.num_res_blocks,
            channel_multipliers=tuple(cfg.autoencoder.channel_multipliers),
            num_embeddings=cfg.quantizer.num_embeddings,
            embedding_dim=cfg.quantizer.embedding_dim,
            quantizer_type=cfg.quantizer.type,
            quantizer_params=dict(cfg.quantizer.params),
            dtype=dtype,
            generator=generator,
        )
        return model.to(device).eval()

    def _quantize(self, z, train, mask=None, temp=None, kl_cost=None, generator=None):
        if self.quantizer_type == "gumbel":
            return self.quantizer(z, train=train, mask=mask, temp=temp, kl_cost=kl_cost,
                                  generator=generator)
        return self.quantizer(z, train=train, mask=mask)

    def forward(self, x: torch.Tensor, train: bool = False,
                mask: Optional[torch.Tensor] = None, temp: Optional[float] = None,
                kl_cost: Optional[float] = None,
                generator: Optional[torch.Generator] = None):
        """Normalized (-1,1) NHWC images -> (recon (-1,1) NHWC, q_loss,
        codes (B, S) int32). ``train=True`` advances the EMA quantizer's
        buffers (never keyed on ``nn.Module.training``); ``mask``: optional
        (B,) bool, rows with False are left out of the quantizer loss;
        ``temp``, ``kl_cost``, ``generator``: the gumbel quantizer's."""
        z = self.encoder(_nchw(x))
        quantized, codes, q_loss = self._quantize(z, train, mask, temp, kl_cost, generator)
        return _nhwc(self.decoder(quantized)), q_loss, codes

    # tokenizer API (reference model.py:458-489)

    @torch.inference_mode()
    def get_tokens(self, images: torch.Tensor, deterministic: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[0,1] NHWC images -> (B, S) int32 codebook indices. Gumbel: noisy
        argmax of the raw encoder channels unless ``deterministic``."""
        z = self.encoder(_nchw(preprocess_batch(images)))
        if self.quantizer_type == "gumbel":
            return self.quantizer.vec_to_codes(z, deterministic, generator)
        return self.quantizer.vec_to_codes(z)

    @torch.inference_mode()
    def quantize(self, images: torch.Tensor) -> torch.Tensor:
        """[0,1] NHWC images -> (B, S, D) quantized latents."""
        z = self.encoder(_nchw(preprocess_batch(images)))
        quantized, _, _ = self._quantize(z, False)
        b, d = quantized.shape[:2]
        return quantized.reshape(b, d, -1).transpose(1, 2)

    @torch.inference_mode()
    def reconstruct(self, images: torch.Tensor) -> torch.Tensor:
        """[0,1] NHWC images -> [0,1] NHWC reconstructions."""
        recon, _, _ = self(preprocess_batch(images))
        return denormalize(recon)

    @torch.inference_mode()
    def reconstruct_from_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) tokens -> [0,1] NHWC reconstructions."""
        quantized = codes_to_vec(self.quantizer.codebook.weight, tokens)
        b, s, d = quantized.shape
        hw = int(round(s ** 0.5))
        quantized = quantized.reshape(b, hw, hw, d)
        return denormalize(_nhwc(self.decoder(_nchw(quantized))))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Normalized NHWC images -> raw NHWC encoder latents (fp32)."""
        return _nhwc(self.encoder(_nchw(x)))

    def decode(self, quantized: torch.Tensor) -> torch.Tensor:
        """NHWC quantized latents -> normalized NHWC reconstructions."""
        return _nhwc(self.decoder(_nchw(quantized)))
