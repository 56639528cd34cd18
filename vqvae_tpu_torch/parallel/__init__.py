"""Data parallelism over ``torch.distributed`` (counterpart of ``vqvae_tpu/parallel/``)."""
