"""JAX parameters -> state_dicts of the PyTorch port: the inverse of
``vqvae_tpu/utils/torch_convert.py`` (``convert_vqvae_state_dict``,
``convert_discriminator_state_dict``), the LPIPS weights and the FID
InceptionV3's.

Layout mapping (the JAX package is NHWC, the port NCHW):
- flax kernel (kh, kw, I, O)  ->  Conv2d weight (O, I, kh, kw)
- GroupNorm scale / bias (C,)  ->  weight / bias (1, C, 1, 1)
- codebook (N, D)  ->  quantizer.codebook.weight (N, D) unchanged
- EMA ``vq_state`` codebook, ema_count, ema_weight  ->  quantizer buffers of the
  same names, unchanged
- gumbel ``x_to_logits_kernel`` (1, 1, N, N) / ``_bias``  ->
  ``quantizer.x_to_logits.weight`` (N, N, 1, 1) / ``.bias``
- discriminator FC weight (in, out)  ->  (out, in); ``b4.fc``'s input axis
  from the NHWC flatten to the NCHW one
- the converted Inception ``.npz``'s flat keys ``<path>/conv/kernel`` (HWIO)
  / ``<path>/conv/bias``  ->  ``<path with dots>.conv.weight`` (OIHW) / ``.bias``

Takes numpy arrays (``{'params': {...}[, 'vq_state': {...}]}`` for the VQVAE).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _key(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def conv_state(p: dict, prefix: str) -> Dict[str, torch.Tensor]:
    """{kernel[, bias]} of a flax conv -> Conv2d weight[, bias]."""
    out = {_key(prefix, "weight"): _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))}
    if "bias" in p:
        out[_key(prefix, "bias")] = _t(p["bias"])
    return out


def groupnorm_state(p: dict, prefix: str) -> Dict[str, torch.Tensor]:
    """{scale, bias} (C,) -> GroupNorm weight, bias (1, C, 1, 1)."""
    return {_key(prefix, "weight"): _t(p["scale"]).reshape(1, -1, 1, 1),
            _key(prefix, "bias"): _t(p["bias"]).reshape(1, -1, 1, 1)}


def resblock_state(p: dict, prefix: str) -> Dict[str, torch.Tensor]:
    out = {**groupnorm_state(p["norm1"], _key(prefix, "norm1")),
           **conv_state(p["conv1"]["Conv_0"], _key(prefix, "conv1")),
           **groupnorm_state(p["norm2"], _key(prefix, "norm2")),
           **conv_state(p["conv2"]["Conv_0"], _key(prefix, "conv2"))}
    if "conv_shortcut" in p:
        out.update(conv_state(p["conv_shortcut"]["Conv_0"], _key(prefix, "conv_shortcut")))
    return out


def convert_encoder(p: dict, num_res_blocks: int, num_levels: int,
                    prefix: str = "encoder") -> Dict[str, torch.Tensor]:
    """flax Encoder params -> Encoder state (blocks index level*(n+1)+j; the
    parameter-free Downsample holds slot level*(n+1)+n)."""
    n = num_res_blocks
    sd = {**conv_state(p["conv_in"]["Conv_0"], _key(prefix, "conv_in")),
          **groupnorm_state(p["norm_out"], _key(prefix, "norm")),
          **conv_state(p["conv_out"]["Conv_0"], _key(prefix, "conv_out"))}
    for i in range(num_levels):
        for j in range(n):
            sd.update(resblock_state(p[f"down_{i}_block_{j}"],
                                     _key(prefix, f"blocks.{i * (n + 1) + j}")))
    for j in range(n):
        sd.update(resblock_state(p[f"final_block_{j}"], _key(prefix, f"final_residual.{j}")))
    return sd


def convert_decoder(p: dict, num_res_blocks: int, num_levels: int,
                    prefix: str = "decoder") -> Dict[str, torch.Tensor]:
    """flax Decoder params -> Decoder state (blocks position p counts levels
    L-1, ..., 0; each level is n ResBlocks then an Upsample)."""
    n = num_res_blocks
    sd = {**conv_state(p["conv_in"]["Conv_0"], _key(prefix, "conv_in")),
          **groupnorm_state(p["norm_out"], _key(prefix, "norm")),
          **conv_state(p["conv_out"]["Conv_0"], _key(prefix, "conv_out"))}
    for j in range(n):
        sd.update(resblock_state(p[f"initial_block_{j}"], _key(prefix, f"initial_residual.{j}")))
    for pos, i in enumerate(reversed(range(num_levels))):
        for j in range(n):
            sd.update(resblock_state(p[f"up_{i}_block_{j}"],
                                     _key(prefix, f"blocks.{pos * (n + 1) + j}")))
        sd.update(conv_state(p[f"up_{i}_upsample"]["conv"]["Conv_0"],
                             _key(prefix, f"blocks.{pos * (n + 1) + n}.conv")))
    return sd


def convert_vqvae_variables(variables: dict, num_res_blocks: int,
                            num_levels: int) -> Dict[str, torch.Tensor]:
    """Standard- or EMA-VQ flax VQVAE variables -> port VQVAE state_dict, to
    load with ``load_state_dict(strict=True)``. The EMA quantizer's codebook
    and accumulators come from the ``vq_state`` collection."""
    params = variables["params"]
    sd = {**convert_encoder(params["encoder"], num_res_blocks, num_levels),
          **convert_decoder(params["decoder"], num_res_blocks, num_levels)}
    if "vq_state" in variables:
        q = variables["vq_state"]["quantizer"]
        sd.update({"quantizer.codebook.weight": _t(q["codebook"]),
                   "quantizer.ema_count": _t(q["ema_count"]),
                   "quantizer.ema_weight": _t(q["ema_weight"])})
    else:
        q = params["quantizer"]
        sd["quantizer.codebook.weight"] = _t(q["codebook"])
        if "x_to_logits_kernel" in q:
            sd.update(conv_state({"kernel": q["x_to_logits_kernel"],
                                  "bias": q["x_to_logits_bias"]}, "quantizer.x_to_logits"))
    return sd


def _fc_state(p: dict, prefix: str, spatial: int = 0) -> Dict[str, torch.Tensor]:
    """Equalized FC {weight (in, out)[, bias]} -> weight (out, in)[, bias].
    ``spatial`` > 0: the input is a (spatial, spatial, C) NHWC flatten, made
    a (C, spatial, spatial) NCHW one."""
    w = np.asarray(p["weight"])
    if spatial:
        c = w.shape[0] // (spatial * spatial)
        w = w.reshape(spatial, spatial, c, -1).transpose(2, 0, 1, 3).reshape(w.shape[0], -1)
    out = {f"{prefix}.weight": _t(w.T)}
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])
    return out


def convert_discriminator_params(params: dict) -> Dict[str, torch.Tensor]:
    """flax Discriminator params -> port Discriminator state_dict (the
    reference's torch names and layouts; load with ``strict=True``)."""
    sd = {}
    for name, block in params.items():
        if name == "b4":
            continue
        for layer, p in block.items():
            sd[f"{name}.{layer}.weight"] = _t(np.transpose(np.asarray(p["weight"]), (3, 2, 0, 1)))
            if "bias" in p:
                sd[f"{name}.{layer}.bias"] = _t(p["bias"])
    ep = params["b4"]
    sd["b4.conv.weight"] = _t(np.transpose(np.asarray(ep["conv"]["weight"]), (3, 2, 0, 1)))
    sd["b4.conv.bias"] = _t(ep["conv"]["bias"])
    sd.update(_fc_state(ep["fc"], "b4.fc", spatial=4))
    sd.update(_fc_state(ep["out"], "b4.out"))
    return sd


def convert_lpips_params(params: dict) -> Dict[str, torch.Tensor]:
    """JAX LPIPS-VGG params (``{'net': {'conv{i}': {kernel, bias}}, 'lin{i}':
    (C, 1)}``, the layout of the converted ``.npz``) -> port LPIPS state_dict."""
    sd = {}
    for name, p in params["net"].items():
        sd.update(conv_state(p, f"net.{name}"))
    for name, v in params.items():
        if name != "net":
            sd[name] = _t(v)
    return sd


def convert_inception_params(flat: dict) -> Dict[str, torch.Tensor]:
    """The flat dict of the converted FID-inception ``.npz`` (keys such as
    ``Mixed_5b/branch1x1/conv/kernel``, HWIO kernels with BatchNorm folded in,
    as ``tools/convert_inception_weights.py`` writes it) -> the state_dict of
    ``eval.inception.InceptionV3Pool3``."""
    sd = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        prefix = ".".join(path)
        if leaf == "kernel":
            sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(value), (3, 2, 0, 1)))
        elif leaf == "bias":
            sd[f"{prefix}.bias"] = _t(value)
        else:
            raise KeyError(f"unexpected inception weight {key}")
    return sd


def random_inception_npz(path, seed: int) -> str:
    """Write seeded FID-inception weights in the converted ``.npz``'s layout:
    over the sorted keys, one ``RandomState(seed)`` stream draws He-normal
    kernels (std ``sqrt(2 / (H W I))``) and biases ``0.1 N(0, 1)``, the rule of
    the fixture in ``tests/test_golden_rfid.py``. For tests and the card's
    smoke run: the rFID it gives means nothing. The keys and shapes are those
    of the port's module (built on the meta device). -> the path written."""
    from vqvae_tpu_torch.eval.inception import InceptionV3Pool3
    shapes = {}
    for name, t in InceptionV3Pool3().state_dict().items():
        prefix, leaf = name.rsplit(".", 1)
        path_key = prefix.replace(".", "/")
        if leaf == "weight":
            o, i, kh, kw = t.shape
            shapes[f"{path_key}/kernel"] = (kh, kw, i, o)
        else:
            shapes[f"{path_key}/bias"] = tuple(t.shape)
    rs = np.random.RandomState(seed)
    out = {}
    for key, shape in sorted(shapes.items()):
        if key.endswith("/kernel"):
            fan_in = int(np.prod(shape[:-1]))
            out[key] = np.asarray(rs.randn(*shape) * np.sqrt(2.0 / fan_in), np.float32)
        else:
            out[key] = np.asarray(rs.randn(*shape) * 0.1, np.float32)
    np.savez(str(path), **out)
    return str(path)
