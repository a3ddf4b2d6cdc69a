"""FAST-9/16 corner detection and the Harris response.

PyTorch counterpart of `mono_slam_framework_tpu/ops/fast.py`: the segment
test runs on 16 rolled copies of the image with no data-dependent control
flow. Part of the plain version of kernel B1 (`ops/detect.py`).
"""

from __future__ import annotations

import torch

from mono_slam_framework_torch.ops import filters

# Bresenham circle of radius 3: 16 (dy, dx) offsets in clockwise order.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

def _ring(img):
    """[16, H, W] circle-neighbor intensities via circular rolls."""
    return torch.stack(
        [torch.roll(img, (-dy, -dx), dims=(-2, -1)) for dy, dx in CIRCLE]
    )


def _any_arc9(mask):
    """[16, H, W] ring mask -> [H, W]: any 9 circularly contiguous Trues.
    Runs by doubling: a run of 2k at s = run of k at s AND run of k at s+k."""
    a2 = mask & mask.roll(-1, 0)
    a4 = a2 & a2.roll(-2, 0)
    a8 = a4 & a4.roll(-4, 0)
    return (a8 & mask.roll(-8, 0)).any(dim=0)


def _interior3(img):
    h, w = img.shape[-2], img.shape[-1]
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    return (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)


def corner_mask(img, threshold=20.0):
    """FAST-9 corner mask of an [H, W] image (the mask of the JAX package's
    `fast_score_map`): strict `>` against the threshold; the 3 px border the
    rolls wrapped around is never a corner."""
    diff = _ring(img) - img[None]
    is_corner = _any_arc9(diff > threshold) | _any_arc9(diff < -threshold)
    return is_corner & _interior3(img)


def harris_response(img, block_size=7, k=0.04):
    """Harris corner response: Sobel gradients, box-window structure tensor."""
    d = torch.tensor([-1.0, 0.0, 1.0], dtype=img.dtype)
    s = torch.tensor([1.0, 2.0, 1.0], dtype=img.dtype)
    grads = filters.depthwise_sep_conv(
        torch.stack([img, img]), torch.stack([d, s]), torch.stack([s, d])
    )  # [2,H,W]: ix, iy
    ix, iy = grads[0], grads[1]
    prods = torch.stack([ix * ix, iy * iy, ix * iy])
    box = torch.full((3, block_size), 1.0 / block_size, dtype=img.dtype)
    sums = filters.depthwise_sep_conv(prods, box, box)  # [3,H,W]
    sxx, syy, sxy = sums[0], sums[1], sums[2]
    tr = sxx + syy
    return (sxx * syy - sxy * sxy) - k * tr * tr
