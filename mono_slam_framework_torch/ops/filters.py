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


def box_blur(img, size):
    """Box blur of one [H,W] image: SAME, zero padding."""
    k = torch.full((size,), 1.0 / size, dtype=img.dtype)
    return sep_conv2d(img, k, k)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] f32 weights of a 1-D bilinear resize, as
    jax.image.resize builds them (scale_and_translate's compute_weight_mat
    with the triangle kernel and antialias): sample at the output pixel's
    centre, the kernel widened by the shrink factor, each column normalized
    over the input samples it covers."""
    f32 = np.float32
    scale = out_size / in_size
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(img, new_hw):
    """[..., H, W] -> [..., h, w] as jax.image.resize(img, new_hw,
    "bilinear") does (antialiased when it shrinks): two products with the
    separable weight matrices."""
    h, w = img.shape[-2:]
    wy = torch.from_numpy(resize_weights(h, new_hw[-2]).T.copy()).to(img.device, img.dtype)
    wx = torch.from_numpy(resize_weights(w, new_hw[-1])).to(img.device, img.dtype)
    return wy @ img @ wx


def max_pool_3x3_same(x):
    """3x3 max filter with -inf SAME padding over the last two dims (NMS)."""
    return F.max_pool2d(x[None], 3, stride=1, padding=1)[0]
