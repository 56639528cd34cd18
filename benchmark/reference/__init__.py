"""The plain references, one module per architecture, found by name.

A configuration file names its reference by the key ``"reference"``
(``"taming"`` is ``reference/taming.py``); without the key it is ``nets``.
Each module gives:

- ``VQVAE(cfg)``: the autoencoder, with the port's parameter names, so that
  the benchmark's weights load into both. Its ``encoder`` takes normalized
  NCHW images to latents, its ``quantizer.codes`` takes latents to (B, S)
  codes (where the configuration exports tokens), and its
  ``decode_tokens`` takes (B, S) tokens to NHWC images in [0, 1].
- ``latent_side(cfg)``: the side of one image's token map.
- ``tiny(cfg)``: the configuration with its model cut for the CPU tests.

A module whose architecture trains also gives ``decay_names(model,
prefix)``, the leaves that take weight decay; the training reference
(``train.Run``) refuses a configuration whose module has none.
"""

from __future__ import annotations

import importlib


def of(cfg: dict):
    """The reference module of configuration ``cfg``."""
    return importlib.import_module(f"{__name__}.{cfg.get('reference', 'nets')}")
