"""Command-line entry points of the port: ``python -m vqvae_tpu_torch.cli.train``
and ``python -m vqvae_tpu_torch.cli.create_packed_dataset``."""
