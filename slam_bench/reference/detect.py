"""Plain reference of kernel B1: the five ORB detection maps of a level stack.

Frozen copy of the plain version the program's kernel B1 computes:
`mono_slam_framework_torch/ops/detect.py:69-135` (`level_layout`,
`moment_maps`, `level_maps_plain`, `detect_maps_plain`),
`ops/fast.py:13-64, 82-97` (the FAST-9 ring test, Harris) and
`ops/filters.py:13-52, 88-90` (separable SAME convolutions, the Gaussian,
3x3 max). For every pixel of every level of a row-stacked pyramid:
score (Harris at FAST-9 corners inside the border that survive 3x3 NMS,
-inf elsewhere), the 31x31 intensity moments m10 / m01, the 7x7 sigma-2
blur and the raw Harris surface. Each convolution's operands go through
`precision.round_operand`, so the same code is the control one precision
lower.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from slam_bench.reference.precision import round_operand

PATCH_RADIUS = 15
CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
          (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))
MAPS = ("score", "m10", "m01", "blur", "harris")
PAD_VALUES = (-float("inf"), 0.0, 0.0, 0.0, 0.0)


def level_layout(dims):
    row0, r = [], 0
    for h, _ in dims:
        row0.append(r)
        r += h
    return tuple(row0), r, max(w for _, w in dims)


def _sep_conv(x, kxs, kys, mode):
    """Per-channel separable SAME cross-correlation of [C, H, W]: rows with
    kys, then columns with kxs."""
    c = x.shape[0]
    kys = round_operand(torch.as_tensor(kys, dtype=x.dtype, device=x.device), mode)
    kxs = round_operand(torch.as_tensor(kxs, dtype=x.dtype, device=x.device), mode)
    ry, rx = kys.shape[1] // 2, kxs.shape[1] // 2
    out = F.conv2d(round_operand(x, mode)[None], kys[:, None, :, None], padding=(ry, 0), groups=c)
    out = F.conv2d(round_operand(out, mode), kxs[:, None, None, :], padding=(0, rx), groups=c)
    return out[0]


def _any_arc9(mask):
    a2 = mask & mask.roll(-1, 0)
    a4 = a2 & a2.roll(-2, 0)
    a8 = a4 & a4.roll(-4, 0)
    return (a8 & mask.roll(-8, 0)).any(dim=0)


def corner_mask(img, threshold):
    ring = torch.stack([torch.roll(img, (-dy, -dx), dims=(-2, -1)) for dy, dx in CIRCLE])
    diff = ring - img[None]
    h, w = img.shape
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    inner = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return (_any_arc9(diff > threshold) | _any_arc9(diff < -threshold)) & inner


def harris_response(img, mode, block_size=7, k=0.04):
    d = torch.tensor([-1.0, 0.0, 1.0])
    s = torch.tensor([1.0, 2.0, 1.0])
    g = _sep_conv(torch.stack([img, img]), torch.stack([d, s]), torch.stack([s, d]), mode)
    ix, iy = g[0], g[1]
    box = torch.full((3, block_size), 1.0 / block_size)
    sums = _sep_conv(torch.stack([ix * ix, iy * iy, ix * iy]), box, box, mode)
    sxx, syy, sxy = sums[0], sums[1], sums[2]
    tr = sxx + syy
    return (sxx * syy - sxy * sxy) - k * tr * tr


def _gaussian(size=7, sigma=2.0):
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return torch.from_numpy((g / g.sum()).astype(np.float32))


def level_maps(img, threshold, border, mode):
    h, w = img.shape
    harris = harris_response(img, mode)
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    inside = (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    cand = torch.where(corner_mask(img, threshold) & inside, harris, -torch.inf)
    nms = F.max_pool2d(cand[None], 3, stride=1, padding=1)[0]
    score = torch.where(cand >= nms, cand, -torch.inf)
    r = PATCH_RADIUS
    ones = torch.ones(2 * r + 1)
    ramp = torch.arange(-r, r + 1, dtype=torch.float32)
    mom = _sep_conv(torch.stack([img, img]), torch.stack([ramp, ones]), torch.stack([ones, ramp]), mode)
    g = _gaussian()
    blur = _sep_conv(img[None], g[None], g[None], mode)[0]
    return (score, mom[0], mom[1], blur, harris)


def detect_maps(stack, dims, threshold: float = 20.0, border: int = 31, mode: str = "f32"):
    """The five maps ([rows, w0] each, padded columns score -inf and 0) of
    a [rows, w0] f32 level stack."""
    row0, _, w0 = level_layout(dims)
    levels = []
    for (h, w), r in zip(dims, row0):
        maps = level_maps(stack[r : r + h, :w].contiguous(), threshold, border, mode)
        levels.append([F.pad(m, (0, w0 - w), value=v) for m, v in zip(maps, PAD_VALUES)])
    return tuple(torch.cat(ms) for ms in zip(*levels))
