"""vqvae_tpu_torch: the PyTorch / CUDA port of ``vqvae_tpu`` for NVIDIA Hopper.

Module paths mirror ``vqvae_tpu/``. The port carries the VQ-VAE / VQGAN with
all four quantizers and its tokenizer API (``VQVAE.get_tokens`` /
``reconstruct`` / ``reconstruct_from_tokens``), the training step and loop
with the LPIPS + StyleGAN2 loss stack (``train.loop``), eval (``eval``:
L2 / PSNR / SSIM / rFID) and the CLIs (``cli``: train, evaluate,
tokenize_dataset, create_packed_dataset), with the TPU kernels written for
``sm_90a`` (``csrc/``). The package imports ``torch`` and never ``jax`` nor
``vqvae_tpu``; configs are parsed by its own ``config`` module.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level conveniences (keep ``import vqvae_tpu_torch`` light)."""
    if name == "VQVAE":
        from vqvae_tpu_torch.models.vqvae import VQVAE
        return VQVAE
    if name in ("Config", "load_config", "parse_config"):
        from vqvae_tpu_torch import config
        return getattr(config, name)
    raise AttributeError(f"module 'vqvae_tpu_torch' has no attribute {name!r}")
