"""Reference (PyTorch-Lightning) checkpoints -> state_dicts of the port
(counterpart of ``vqvae_tpu/utils/torch_convert.py``).

The port's modules carry the reference's names and NCHW layouts (the
encoder's ``blocks.{level (n + 1) + j}`` with the parameter-free Downsample
in slot ``level (n + 1) + n``; the decoder's levels in reverse; GroupNorm
weights ``(1, C, 1, 1)``; the EMA quantizer's ``codebook.weight`` /
``ema_count`` / ``ema_weight`` buffers; the gumbel ``x_to_logits`` 1x1
conv; the discriminator's ``b{res}.*`` blocks and ``b4`` epilogue), so a
reference state_dict is the port's state_dict: the conversion is a check of
every key and shape against the port's module, built for the config on the
meta device (no memory, no weights drawn). A missing, extra or misshapen
key raises, naming it; nothing is skipped but what is named below.

Reference checkpoints hold a LightningModule's ``state_dict``; its loss
stack (``criterion.*``) is dropped by the import CLI, as the JAX tool drops
it (``tools/import_torch_checkpoint.py``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from vqvae_tpu_torch.config import Config

Tensors = Mapping[str, "torch.Tensor | np.ndarray"]


def _as_float32(v) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
    return t.detach().to(torch.float32).contiguous()


def check_state_dict(sd: Tensors, template: nn.Module, what: str) -> Dict[str, torch.Tensor]:
    """``sd`` against ``template.state_dict()``: the same keys and shapes, or
    KeyError / ValueError naming the keys. -> ``sd`` as fp32 tensors."""
    want = template.state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"{what}: state_dict keys do not match the port's module: "
                       f"missing {missing}, unexpected {extra}")
    for key, value in sd.items():
        if tuple(value.shape) != tuple(want[key].shape):
            raise ValueError(f"{what}: {key} has shape {tuple(value.shape)}, the port's "
                             f"module wants {tuple(want[key].shape)}")
    return {k: _as_float32(v) for k, v in sd.items()}


def vqvae_template(cfg: Config) -> nn.Module:
    """The port's VQVAE for ``cfg`` on the meta device: its keys and shapes."""
    from vqvae_tpu_torch.models.vqvae import VQVAE
    with torch.device("meta"):
        return VQVAE(cfg)


def convert_vqvae_state_dict(sd: Tensors, cfg: Config) -> Dict[str, torch.Tensor]:
    """A reference VQVAE state_dict (``encoder.*``, ``decoder.*``,
    ``quantizer.*``; any of the four quantizers) -> the port's VQVAE
    state_dict for ``cfg``, to load with ``load_state_dict(strict=True)``."""
    return check_state_dict(sd, vqvae_template(cfg), f"{cfg.quantizer.type} VQVAE")


# StyleGAN2's layers keep their FIR as a buffer; the port's layers build it
# themselves (``ops/upfirdn2d.setup_filter([1, 3, 3, 1])``)
_FIR_KEY = "resample_filter"


def convert_discriminator_state_dict(sd: Tensors, img_resolution: int,
                                     channel_base: int = 32768,
                                     channel_max: int = 512) -> Dict[str, torch.Tensor]:
    """A reference StyleGAN2 discriminator state_dict (``b{res}.*`` blocks and
    the ``b4`` epilogue; reference discriminator.py:360-412) -> the port's
    ``Discriminator`` state_dict. Keys ending in ``resample_filter`` (the
    layers' fixed FIR buffers, which the JAX converter also leaves out) must
    hold the [1, 3, 3, 1] filter the port builds; they are dropped."""
    from vqvae_tpu_torch.models.discriminator import Discriminator
    from vqvae_tpu_torch.ops.upfirdn2d import setup_filter
    fir = torch.from_numpy(setup_filter([1, 3, 3, 1]))
    weights = {}
    for key, value in sd.items():
        if key.rsplit(".", 1)[-1] != _FIR_KEY:
            weights[key] = value
        elif not torch.equal(_as_float32(value), fir):
            raise ValueError(f"discriminator: {key} is not the [1, 3, 3, 1] filter the port uses")
    with torch.device("meta"):
        template = Discriminator(img_resolution, channel_base=channel_base,
                                 channel_max=channel_max, device="meta")
    return check_state_dict(weights, template, "discriminator")
