"""Kernel B1: the fused ORB detection maps over a whole pyramid.

Hopper counterpart of `mono_slam_framework_tpu/ops/pallas_detect.py`. For
every pixel of every pyramid level it computes

  score   — Harris at FAST-9 corners inside the level's border that survive
            3x3 non-max suppression (-inf elsewhere);
  m10/m01 — 31x31 square-patch intensity moments (orientation);
  blur    — 7x7 Gaussian, sigma 2 (rBRIEF sampling source);
  harris  — the raw Harris surface (subpixel peak fit).

The levels are stacked by rows, each padded to the level-0 width: level l
occupies rows `row0[l] .. row0[l] + h_l` of a [rows, w0] f32 stack (see
`level_layout`). Padded columns hold score -inf and 0 in the other maps.

`detect_maps` runs `detect_maps_plain` for a CPU stack and launches the
kernel (`csrc/detect.cu`, `detect_maps_cuda`) for a CUDA stack.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mono_slam_framework_torch import _kernels
from mono_slam_framework_torch.ops import fast, filters

PATCH_RADIUS = 15  # intensity-centroid patch (HALF_PATCH_SIZE)
TILE = 32  # output tile side of the CUDA kernel


class DetectMaps(NamedTuple):
    score: torch.Tensor
    m10: torch.Tensor
    m01: torch.Tensor
    blur: torch.Tensor
    harris: torch.Tensor


@functools.lru_cache(maxsize=None)
def level_layout(dims):
    """(row0 per level, total rows, w0) of the row-stacked pyramid for a
    tuple of per-level (h, w)."""
    row0, r = [], 0
    for h, _ in dims:
        row0.append(r)
        r += h
    return tuple(row0), r, max(w for _, w in dims)


def moment_maps(img):
    """Square-patch intensity moments (m10, m01) of an [H,W] image: one
    grouped separable 31-tap pass over a 2-channel stack. Convolutions are
    cross-correlations, so the raw ramp gives m10 = sum dx * I(x + dx)."""
    r = PATCH_RADIUS
    ones = torch.ones(2 * r + 1, dtype=img.dtype)
    ramp = torch.arange(-r, r + 1, dtype=img.dtype)
    out = filters.depthwise_sep_conv(
        torch.stack([img, img]),
        torch.stack([ramp, ones]),  # kx per channel
        torch.stack([ones, ramp]),  # ky per channel
    )
    return out[0], out[1]


def level_maps_plain(img, threshold: float = 20.0, border: int = 31):
    """The five maps of one [h, w] level, as the JAX package's unfused path
    computes them (FAST + Harris + interior mask + NMS, moments, blur)."""
    h, w = img.shape
    is_corner = fast.corner_mask(img, threshold)
    harris = fast.harris_response(img)
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    inside = (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    cand = torch.where(is_corner & inside, harris, -torch.inf)
    score = torch.where(cand >= filters.max_pool_3x3_same(cand), cand, -torch.inf)
    m10, m01 = moment_maps(img)
    return DetectMaps(score, m10, m01, filters.gaussian_blur(img), harris)


def _check_stack(stack, dims):
    dims = tuple((int(h), int(w)) for h, w in dims)
    _, rows, w0 = level_layout(dims)
    if stack.dtype != torch.float32:
        raise TypeError(f"detection takes an f32 stack, got {stack.dtype}")
    if tuple(stack.shape) != (rows, w0):
        raise ValueError(
            f"stack has shape {tuple(stack.shape)}, the layout needs {(rows, w0)}"
        )
    return dims


def detect_maps_plain(stack, dims, threshold: float = 20.0, border: int = 31):
    """Plain PyTorch version of kernel B1 over a [rows, w0] level stack."""
    dims = _check_stack(stack, dims)
    row0, rows, w0 = level_layout(dims)
    pad_values = (-torch.inf, 0.0, 0.0, 0.0, 0.0)  # score -inf, the other maps 0
    levels = []
    for (h, w), r in zip(dims, row0):
        maps = level_maps_plain(stack[r : r + h, :w], threshold, border)
        levels.append([F.pad(m, (0, w0 - w), value=v) for m, v in zip(maps, pad_values)])
    return DetectMaps(*(torch.cat(ms) for ms in zip(*levels)))


@functools.lru_cache(maxsize=None)
def _level_table(dims, device):
    """Device table [L, 4] int32 = (row0, h, w, first tile row), and the
    total number of tile rows."""
    row0, _, _ = level_layout(dims)
    rows, t = [], 0
    for (h, w), r in zip(dims, row0):
        rows.append((r, h, w, t))
        t += -(-h // TILE)
    return torch.tensor(rows, dtype=torch.int32, device=device), t


def detect_maps_cuda(stack, dims, threshold: float = 20.0, border: int = 31):
    """Kernel B1: one launch over every level of a CUDA [rows, w0] stack."""
    if stack.device.type != "cuda":
        raise ValueError(f"detect_maps_cuda needs a CUDA tensor, got {stack.device}")
    dims = _check_stack(stack, dims)
    if not stack.is_contiguous():
        raise ValueError("the level stack is not contiguous")
    _, rows, w0 = level_layout(dims)
    table, n_tile_rows = _level_table(dims, stack.device)
    lib = _kernels.load()
    out = torch.empty((5, rows, w0), dtype=torch.float32, device=stack.device)
    err = lib.detect_maps_launch(
        stack.data_ptr(), out.data_ptr(), table.data_ptr(), len(dims),
        n_tile_rows, rows, w0, float(threshold), int(border),
        _kernels.stream_ptr(stack.device),
    )
    _kernels.check(err, "detect_maps_launch")
    detect_maps_cuda.launches += 1
    return DetectMaps(*out.unbind(0))


detect_maps_cuda.launches = 0


def detect_maps(stack, dims, threshold: float = 20.0, border: int = 31):
    """The five detection maps of a level stack: the plain version for a CPU
    tensor, kernel B1 for a CUDA tensor."""
    if stack.is_cuda:
        return detect_maps_cuda(stack, dims, threshold, border)
    return detect_maps_plain(stack, dims, threshold, border)
