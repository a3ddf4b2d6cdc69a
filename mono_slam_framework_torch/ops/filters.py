"""Separable image filters used by the ORB front end.

PyTorch counterpart of `mono_slam_framework_tpu/ops/filters.py`. All
convolutions are SAME cross-correlations with zero padding, like
`lax.conv_general_dilated`, on f32 images ([H,W] or [C,H,W]).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def depthwise_sep_conv(x, kxs, kys):
    """Per-channel separable SAME convolution.

    x: [C, H, W]; kxs/kys: [C, k] per-channel 1-D kernels (odd k). Rows are
    filtered with kys first, then columns with kxs.
    """
    c = x.shape[0]
    kys = torch.as_tensor(kys, dtype=x.dtype, device=x.device)
    kxs = torch.as_tensor(kxs, dtype=x.dtype, device=x.device)
    ry, rx = kys.shape[1] // 2, kxs.shape[1] // 2
    out = F.conv2d(x[None], kys[:, None, :, None], padding=(ry, 0), groups=c)
    out = F.conv2d(out, kxs[:, None, None, :], padding=(0, rx), groups=c)
    return out[0]


def sep_conv2d(img, kx, ky):
    """Separable SAME convolution of one [H,W] image: rows with ky, cols with kx."""
    kx = torch.as_tensor(kx, dtype=img.dtype, device=img.device)
    ky = torch.as_tensor(ky, dtype=img.dtype, device=img.device)
    return depthwise_sep_conv(img[None], kx[None], ky[None])[0]


@functools.lru_cache(maxsize=None)
def _gaussian_kernel_np(size: int, sigma: float):
    x = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img, size=7, sigma=2.0):
    """Gaussian blur (OpenCV ORB blurs with 7x7 sigma 2 before rBRIEF)."""
    k = torch.from_numpy(_gaussian_kernel_np(size, sigma))
    return sep_conv2d(img, k, k)


def max_pool_3x3_same(x):
    """3x3 max filter with -inf SAME padding over the last two dims (NMS)."""
    return F.max_pool2d(x[None], 3, stride=1, padding=1)[0]
