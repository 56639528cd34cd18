"""Command-line entry points of the port: ``python -m vqvae_tpu_torch.cli.train``,
``.evaluate``, ``.tokenize_dataset`` and ``.create_packed_dataset``."""
