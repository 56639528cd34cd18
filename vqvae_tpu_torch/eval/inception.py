"""The FID InceptionV3 in ``torch.nn`` (counterpart of
``vqvae_tpu/eval/inception.py``): the network of the TF-ported
``pt_inception-2015-12-05`` weights that torchmetrics / pytorch-fid use, the
reference's rFID metric (model.py:497), up to its 2048-d pool3 features.

The FID quirks it keeps:
- the pool branches of InceptionA / C / E average with
  ``count_include_pad=False``;
- the second InceptionE block (Mixed_7c) takes a **max** pool in its pool
  branch, as the original TF graph does;
- the input pipeline of torchmetrics' NoTrainInceptionV3 (torch-fidelity's
  'inception-v3-compat'): uint8 -> float 0..255 -> TF1's bilinear resize to
  299 (asymmetric coordinates ``in = out * H / 299``, edge-clamped, not
  ``F.interpolate``'s half-pixel convention) as two dense fp32 matrices ->
  ``(x - 128) / 128`` -> the network -> the global average pool.

BatchNorm is folded into each conv's weight and bias when the weights are
converted (``tools/convert_inception_weights.py``), so a layer is conv + bias
+ relu. The module takes NHWC input, as the JAX package's, and runs NCHW
inside. Every convolution and the resize run in fp32 with TF32 off: FID is
sensitive to precision, and the JAX package runs it at ``HIGHEST``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vqvae_tpu_torch.utils.precision import full_fp32


class ConvBN(nn.Module):
    """BasicConv2d with BatchNorm folded in: conv (with bias) + relu."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                              bias=True, device="meta")

    def forward(self, x):
        return F.relu(self.conv(x))


def _avg_pool_cip_false(x):
    """3x3 stride-1 'same' average pool with count_include_pad=False."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = ConvBN(in_ch, 64, 1)
        self.branch5x5_1 = ConvBN(in_ch, 48, 1)
        self.branch5x5_2 = ConvBN(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = ConvBN(in_ch, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, padding=1)
        self.branch_pool = ConvBN(in_ch, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_cip_false(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = ConvBN(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = ConvBN(in_ch, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = ConvBN(in_ch, 192, 1)
        self.branch7x7_1 = ConvBN(in_ch, c7, 1)
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = ConvBN(in_ch, c7, 1)
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = ConvBN(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                      self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool_cip_false(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = ConvBN(in_ch, 192, 1)
        self.branch3x3_2 = ConvBN(192, 320, 3, stride=2)
        self.branch7x7x3_1 = ConvBN(in_ch, 192, 1)
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = ConvBN(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(nn.Module):
    """``pool_type`` 'avg' (count_include_pad=False) for Mixed_7b, 'max' for
    Mixed_7c."""

    def __init__(self, in_ch: int, pool_type: str = "avg"):
        super().__init__()
        self.pool_type = pool_type
        self.branch1x1 = ConvBN(in_ch, 320, 1)
        self.branch3x3_1 = ConvBN(in_ch, 384, 1)
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = ConvBN(in_ch, 448, 1)
        self.branch3x3dbl_2 = ConvBN(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = ConvBN(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool_type == "avg":
            bp = _avg_pool_cip_false(x)
        else:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionV3Pool3(nn.Module):
    """The FID InceptionV3 up to the 2048-d pool3 features. Built on the meta
    device: its weights come from ``load_state_dict(..., assign=True)``
    (``make_pool3_extractor``) or ``to_empty``."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = ConvBN(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, 3)
        self.Conv2d_2b_3x3 = ConvBN(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = ConvBN(64, 80, 1)
        self.Conv2d_4a_3x3 = ConvBN(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Preprocessed NHWC images -> (B, 2048) pool3 features."""
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
        x = _max_pool(x)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                      self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                      self.Mixed_7c):
            x = block(x)
        return x.mean(dim=(2, 3))


def tf1_bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) fp32 matrix of TF1's ``resize_bilinear`` with
    align_corners=False: ``in = out * in_size / out_size`` (asymmetric, no
    half-pixel offsets), the upper tap edge-clamped; the resize inside
    torch-fidelity's ``interpolate_bilinear_2d_like_tensorflow1x``."""
    coords = np.arange(out_size, dtype=np.float64) * (in_size / out_size)
    lower = np.floor(coords).astype(np.int64)
    upper = np.minimum(lower + 1, in_size - 1)
    frac = coords - lower
    mat = np.zeros((out_size, in_size), np.float64)
    np.add.at(mat, (np.arange(out_size), lower), 1.0 - frac)
    np.add.at(mat, (np.arange(out_size), upper), frac)
    return mat.astype(np.float32)


def preprocess_fid_input(images_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> the 'inception-v3-compat' input, NHWC fp32: float
    0..255, TF1's asymmetric bilinear resize to 299, then ``(x - 128) / 128``
    (the resize first, on raw 0..255 values, as torch-fidelity does)."""
    x = images_uint8.float()
    _, h, w, _ = x.shape
    if (h, w) != (299, 299):
        mat_h = torch.from_numpy(tf1_bilinear_matrix(h, 299)).to(x.device)
        mat_w = torch.from_numpy(tf1_bilinear_matrix(w, 299)).to(x.device)
        with full_fp32():
            x = torch.einsum("bhwc,Hh->bHwc", x, mat_h)
            x = torch.einsum("bHwc,Ww->bHWc", x, mat_w)
    return (x - 128.0) / 128.0


def make_pool3_extractor(weights_path, device="cuda"):
    """(uint8 NHWC images, array or tensor) -> (B, 2048) float32 numpy pool3
    features, with the weights of the converted ``.npz`` at ``weights_path``
    (the file the JAX package reads) on ``device``, the card unless the
    caller asks for the CPU."""
    from vqvae_tpu_torch.utils.convert import convert_inception_params
    flat = dict(np.load(str(Path(weights_path))))
    device = torch.device(device)
    model = InceptionV3Pool3()
    model.load_state_dict({k: v.to(device) for k, v in convert_inception_params(flat).items()},
                          strict=True, assign=True)
    model.eval()

    @torch.inference_mode()
    def extract(images_uint8) -> np.ndarray:
        images = torch.as_tensor(images_uint8).to(device)
        with full_fp32():
            feats = model(preprocess_fid_input(images))
        return feats.cpu().numpy()

    extract.model = model
    return extract
