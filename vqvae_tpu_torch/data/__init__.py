"""Datasets and batch loaders of the port (counterpart of ``vqvae_tpu/data``)."""
