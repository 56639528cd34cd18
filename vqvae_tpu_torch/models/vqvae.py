"""The VQ-VAE: encoder -> quantizer -> decoder (counterpart of
``vqvae_tpu/models/vqvae.py:34-158``).

The public methods keep the JAX package's layout: NHWC images in [0,1]
(float or uint8), normalized NHWC images in (-1,1) for ``forward`` /
``encode`` / ``decode``, and int32 tokens (B, H*W) in row-major (h, w)
order. The modules inside take NCHW-shaped tensors, contiguous or, in the
bf16 inference autoencoder, channels-last in memory
(``models/autoencoder.layout``); either way ``to_nhwc`` gives the public
layout back. The tokenizer API (``get_tokens``,
``quantize``, ``reconstruct``, ``reconstruct_from_tokens``) runs under
``torch.inference_mode()``.

Spans (``utils/introspect.named_scope``): ``quantizer`` around the
quantizer's call, ``api.get_tokens`` and ``api.reconstruct_from_tokens``
around those calls (``quantizer.lookup`` around the latter's codebook
lookup); ``encoder`` and ``decoder`` are the modules' own.

``remat=True`` checkpoints every residual block of the encoder and decoder
in training (``models/autoencoder.py``); it changes no value and no key.

The autoencoder's layout (``config.AutoencoderConf.layout``) is SerezD's
or taming-transformers', decided in ``models/autoencoder.py`` alone; the
quantizer and the methods below are the same for both.

For the gumbel quantizer the encoder emits ``num_embeddings`` channels
(reference model.py:130); ``temp`` and ``kl_cost`` are call-time arguments
(the schedules' values), and ``generator`` draws the gumbel noise.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vqvae_tpu_torch.config import Config
from vqvae_tpu_torch.models.autoencoder import build_autoencoder
from vqvae_tpu_torch.models.preprocess import denormalize, preprocess_batch, to_nchw, to_nhwc
from vqvae_tpu_torch.models.quantizers import codes_to_vec, make_quantizer
from vqvae_tpu_torch.utils.introspect import named_scope


class VQVAE(nn.Module):
    """Encoder + quantizer + decoder (reference model.py:25-161), built from
    a parsed config (the port's, or the JAX package's that tests hand in):
    the quantizer from ``cfg.quantizer``, the two halves in the config's
    layout (``models/autoencoder.build_autoencoder``). Parameters are drawn
    from ``generator`` in that order."""

    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, remat: bool = False):
        super().__init__()
        q = cfg.quantizer
        self.quantizer_type = q.type
        self.quantizer = make_quantizer(q.type, q.num_embeddings, q.embedding_dim,
                                        dict(q.params), generator)
        self.encoder, self.decoder = build_autoencoder(
            cfg.autoencoder, cfg.image_size, cfg.encoder_out_channels, q.embedding_dim,
            dtype, generator, remat)

    @classmethod
    def from_config(cls, cfg: Config, dtype: torch.dtype = torch.float32,
                    device="cuda", generator: Optional[torch.Generator] = None,
                    remat: bool = False) -> "VQVAE":
        """Build from a parsed config; parameters are drawn on the CPU from
        ``generator`` (a seed gives the same weights on every device), then
        moved to ``device``, the card unless the caller asks for the CPU.
        Returns the model in eval mode."""
        return cls(cfg, dtype, generator, remat).to(device).eval()

    def _quantize(self, z, train, mask=None, temp=None, kl_cost=None, generator=None):
        with named_scope("quantizer", images=z.shape[0]):
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
        z = self.encoder(to_nchw(x))
        quantized, codes, q_loss = self._quantize(z, train, mask, temp, kl_cost, generator)
        return to_nhwc(self.decoder(quantized)), q_loss, codes

    # tokenizer API (reference model.py:458-489)

    @torch.inference_mode()
    def get_tokens(self, images: torch.Tensor, deterministic: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[0,1] NHWC images -> (B, S) int32 codebook indices. Gumbel: noisy
        argmax of the raw encoder channels unless ``deterministic``."""
        with named_scope("api.get_tokens", images=images.shape[0]):
            z = self.encoder(to_nchw(preprocess_batch(images)))
            with named_scope("quantizer", images=z.shape[0]):
                if self.quantizer_type == "gumbel":
                    return self.quantizer.vec_to_codes(z, deterministic, generator)
                return self.quantizer.vec_to_codes(z)

    @torch.inference_mode()
    def quantize(self, images: torch.Tensor) -> torch.Tensor:
        """[0,1] NHWC images -> (B, S, D) quantized latents."""
        z = self.encoder(to_nchw(preprocess_batch(images)))
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
        with named_scope("api.reconstruct_from_tokens", images=tokens.shape[0]):
            with named_scope("quantizer.lookup"):
                quantized = codes_to_vec(self.quantizer.codebook.weight, tokens)
            b, s, d = quantized.shape
            hw = int(round(s ** 0.5))
            quantized = quantized.reshape(b, hw, hw, d)
            return denormalize(to_nhwc(self.decoder(to_nchw(quantized))))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Normalized NHWC images -> raw NHWC encoder latents (fp32)."""
        return to_nhwc(self.encoder(to_nchw(x)))

    def decode(self, quantized: torch.Tensor) -> torch.Tensor:
        """NHWC quantized latents -> normalized NHWC reconstructions."""
        return to_nhwc(self.decoder(to_nchw(quantized)))
