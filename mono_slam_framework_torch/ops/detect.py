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
`detect_maps_batch` does the same for N streams' stacks [N, rows, w0]: one
launch serves all of them (`detect_maps_batch_cuda`, the Hopper form of
`pallas_detect.detect_stage_multi_bands(..., n_streams=N)`), and each map
comes back as [N, rows, w0]; its plain version is `detect_maps_plain` per
stream.

`detect_level` is the same kernel launched over ONE level at the level's own
width: the Hopper form of the JAX package's per-level Pallas kernels
`_banded_kernel` (levels taller than 96 rows, cut into 64-row VMEM bands) and
`_full_kernel` (at most 96 rows, one program), which `pallas_detect.
detect_stage` launches. On the card the band split has no reason to exist: a
32x64 tile with a 16-px halo covers a level of any height.
`detect_maps_per_level` stacks such launches into the one-launch layout.

`tile_plan` is the launch's grid in plain Python (no card needed).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mono_slam_framework_torch import _kernels
from mono_slam_framework_torch.ops import fast, filters

PATCH_RADIUS = 15  # intensity-centroid patch (HALF_PATCH_SIZE)
TILE_ROWS, TILE_COLS = 32, 64  # the CUDA kernel's output tile
# shared memory of one block of the kernel (csrc/detect.cu): the window with
# its 16-px halo and an odd row stride, the moments' row sums (later the
# Harris 7-row sums), the Gaussian column sums (later the Harris surface)
SMEM_BYTES = 4 * ((TILE_ROWS + 32) * (TILE_COLS + 33) + 2 * (TILE_ROWS + 30) * (TILE_COLS + 1)
                  + (TILE_ROWS + 2) * (TILE_COLS + 3))
# levels of at most this many rows stand for the JAX package's
# whole-level `_full_kernel`, taller ones for `_banded_kernel`
# (pallas_detect._SMALL_ROWS); the launch is the same
FULL_MAX_ROWS = 96
PAD_VALUES = (-torch.inf, 0.0, 0.0, 0.0, 0.0)  # padded columns: score -inf, the other maps 0


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


def _check_stack(stack, dims, lead=()):
    dims = tuple((int(h), int(w)) for h, w in dims)
    _, rows, w0 = level_layout(dims)
    if stack.dtype != torch.float32:
        raise TypeError(f"detection takes an f32 stack, got {stack.dtype}")
    if tuple(stack.shape) != (*lead, rows, w0):
        raise ValueError(
            f"stack has shape {tuple(stack.shape)}, the layout needs {(*lead, rows, w0)}"
        )
    return dims


def _levels_stacked(stack, dims, threshold, border, level_fn):
    """level_fn over each [h, w] level of a [rows, w0] stack, the results
    padded to w0 and stacked back into the one-launch layout."""
    dims = _check_stack(stack, dims)
    row0, rows, w0 = level_layout(dims)
    levels = []
    for (h, w), r in zip(dims, row0):
        maps = level_fn(stack[r : r + h, :w].contiguous(), threshold, border)
        levels.append([F.pad(m, (0, w0 - w), value=v) for m, v in zip(maps, PAD_VALUES)])
    return DetectMaps(*(torch.cat(ms) for ms in zip(*levels)))


def detect_maps_plain(stack, dims, threshold: float = 20.0, border: int = 31):
    """Plain PyTorch version of kernel B1 over a [rows, w0] level stack."""
    return _levels_stacked(stack, dims, threshold, border, level_maps_plain)


def detect_maps_batch_plain(stacks, dims, threshold: float = 20.0, border: int = 31):
    """Plain version of B1's batched launch: `detect_maps_plain` on each of
    N stacks [N, rows, w0]; each map [N, rows, w0]."""
    _check_stack(stacks, dims, lead=stacks.shape[:1])
    per_stream = [detect_maps_plain(s, dims, threshold, border) for s in stacks]
    return DetectMaps(*(torch.stack(ms) for ms in zip(*per_stream)))


class TilePlan(NamedTuple):
    grid: tuple  # (tile columns over w0, tile rows over all levels)
    table: tuple  # per level (row0, h, w, first tile row)
    pad_tiles: int  # tiles wholly in a level's padded columns (constants only)


@functools.lru_cache(maxsize=None)
def tile_plan(dims) -> TilePlan:
    """B1's grid over the row-stacked levels `dims`: TILE_ROWS x TILE_COLS
    output tiles, tile row t of level l covering its rows from
    (t - first tile row) * TILE_ROWS, tile column j its columns from
    j * TILE_COLS, clipped to the level's h and the stack's w0."""
    row0, _, w0 = level_layout(dims)
    gx = _ceil_div(w0, TILE_COLS)
    table, t, pad = [], 0, 0
    for (h, w), r in zip(dims, row0):
        table.append((r, h, w, t))
        t += _ceil_div(h, TILE_ROWS)
        pad += _ceil_div(h, TILE_ROWS) * (gx - _ceil_div(w, TILE_COLS))
    return TilePlan((gx, t), tuple(table), pad)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def _device_table(dims, device):
    return torch.tensor(tile_plan(dims).table, dtype=torch.int32, device=device)


def _launch(stacks, dims, threshold, border):
    """One launch of the B1 kernel over the levels `dims` of N CUDA stacks
    [N, rows, w0]. The output is one [5, N, rows, w0] tensor; each map
    comes back as its [N, rows, w0] view."""
    if stacks.device.type != "cuda":
        raise ValueError(f"the B1 kernel needs a CUDA tensor, got {stacks.device}")
    if stacks.dim() != 3:
        raise ValueError(f"the launch takes stacks [N, rows, w0], got {tuple(stacks.shape)}")
    dims = _check_stack(stacks, dims, lead=stacks.shape[:1])
    if not stacks.is_contiguous():
        raise ValueError("the level stacks are not contiguous")
    n = stacks.shape[0]
    _, rows, w0 = level_layout(dims)
    (gx, gy), table = tile_plan(dims).grid, _device_table(dims, stacks.device)
    out = torch.empty((5, n, rows, w0), dtype=torch.float32, device=stacks.device)
    err = _kernels.load().detect_maps_batch_launch(
        stacks.data_ptr(), out.data_ptr(), table.data_ptr(), len(dims), gx, gy, n, rows, w0,
        float(threshold), int(border), _kernels.stream_ptr(stacks.device),
    )
    _kernels.check(err, "detect_maps_batch_launch")
    return DetectMaps(*out.unbind(0))


def detect_maps_cuda(stack, dims, threshold: float = 20.0, border: int = 31):
    """Kernel B1: one launch over every level of a CUDA [rows, w0] stack."""
    maps = _launch(stack[None], dims, threshold, border)
    detect_maps_cuda.launches += 1
    return DetectMaps(*(m[0] for m in maps))


detect_maps_cuda.launches = 0


def detect_maps_batch_cuda(stacks, dims, threshold: float = 20.0, border: int = 31):
    """Kernel B1 over N streams in one launch: CUDA stacks [N, rows, w0] ->
    DetectMaps of [N, rows, w0] maps, counted in
    `detect_maps_batch_cuda.launches` (not in `detect_maps_cuda`'s)."""
    maps = _launch(stacks, dims, threshold, border)
    detect_maps_batch_cuda.launches += 1
    return maps


detect_maps_batch_cuda.launches = 0


def detect_level_cuda(img, threshold: float = 20.0, border: int = 31):
    """Kernel B1 over one CUDA [h, w] level (w0 = w): the Hopper form of
    `_banded_kernel` (h > 96) or `_full_kernel` (h <= 96), counted under
    that name in `detect_level_cuda.launches`."""
    h, w = img.shape
    maps = _launch(img[None], ((h, w),), threshold, border)
    detect_level_cuda.launches["full" if h <= FULL_MAX_ROWS else "banded"] += 1
    return DetectMaps(*(m[0] for m in maps))


detect_level_cuda.launches = {"banded": 0, "full": 0}


def detect_maps(stack, dims, threshold: float = 20.0, border: int = 31):
    """The five detection maps of a level stack: the plain version for a CPU
    tensor, kernel B1 for a CUDA tensor."""
    if stack.is_cuda:
        return detect_maps_cuda(stack, dims, threshold, border)
    return detect_maps_plain(stack, dims, threshold, border)


def detect_maps_batch(stacks, dims, threshold: float = 20.0, border: int = 31):
    """The five maps of N streams' level stacks [N, rows, w0], each
    [N, rows, w0]: the plain version for a CPU tensor, one B1 launch for a
    CUDA tensor."""
    if stacks.is_cuda:
        return detect_maps_batch_cuda(stacks, dims, threshold, border)
    return detect_maps_batch_plain(stacks, dims, threshold, border)


def detect_level(img, threshold: float = 20.0, border: int = 31):
    """The five maps of one [h, w] level: `level_maps_plain` for a CPU
    tensor, one kernel launch for a CUDA tensor."""
    if img.is_cuda:
        return detect_level_cuda(img, threshold, border)
    return level_maps_plain(img, threshold, border)


def detect_maps_per_level(stack, dims, threshold: float = 20.0, border: int = 31):
    """`detect_maps` with one `detect_level` call per level in place of one
    launch over the stack; the same maps in the same layout."""
    return _levels_stacked(stack, dims, threshold, border, detect_level)
