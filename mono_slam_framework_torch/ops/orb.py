"""Oriented-BRIEF (ORB) feature extraction with fixed-capacity outputs.

PyTorch counterpart of `mono_slam_framework_tpu/ops/orb.py` (OpenCV ORB
defaults: 8 levels, scale 1.2, Harris ranking, intensity-centroid
orientation, rBRIEF). One image runs as:

  * the 8-level pyramid as per-level bilinear (antialiased triangle) weight
    matmuls from the numpy `_bilinear_weight_mat` tables, stacked by rows;
  * the detection maps of every level in one call (`ops/detect.py`,
    kernel B1 on the card), or with `per_level=True` one call per level;
  * an exact per-level top-k over the score maps with OpenCV's geometric
    per-level budgets (ties may come out in another order than in the JAX
    package: compare feature sets, never slots);
  * a quadratic subpixel peak fit on the Harris surface, atan2 orientation
    from the moment maps, and gather-path rBRIEF on the blur rounded to
    integers, with the seeded shared-point pattern of `_brief_pattern_np`.

Descriptors are int32 [K, 8] words holding the same bits as the JAX
package's uint32 words (`np.uint32` <-> `np.int32` through `.view`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from mono_slam_framework_torch.ops import detect

N_LEVELS = 8
SCALE_FACTOR = 1.2
PATCH_RADIUS = 15  # intensity-centroid patch (HALF_PATCH_SIZE)
BORDER = 31  # edgeThreshold
N_BITS = 256


class Features(NamedTuple):
    """Fixed-capacity feature set for one image."""

    xy: torch.Tensor  # f32 [K, 2] level-0 pixel coords (x, y)
    angle: torch.Tensor  # f32 [K] orientation (radians)
    desc: torch.Tensor  # int32 [K, 8] packed 256-bit rBRIEF (uint32 bits)
    score: torch.Tensor  # f32 [K] Harris response
    valid: torch.Tensor  # bool [K]
    octave: torch.Tensor  # int32 [K] pyramid level (sigma2 = 1.2^(2*octave))


@functools.lru_cache(maxsize=None)
def _brief_pattern_np(seed: int = 1234):
    """(points [256, 2] (yx), perm [256]) — shared-point rBRIEF pattern.

    Gaussian offsets (sigma patch/5, the ORB paper construction) with bit i
    comparing point[i] against point[perm[i]] (a fixed derangement).
    """
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, (2 * PATCH_RADIUS + 1) / 5.0, size=(N_BITS, 2))
    pts = np.clip(np.round(pts), -13, 13).astype(np.float32)
    perm = rng.permutation(N_BITS)
    # make it a derangement so no bit compares a point with itself
    fixed = np.nonzero(perm == np.arange(N_BITS))[0]
    for i in fixed:
        j = (i + 1) % N_BITS
        perm[i], perm[j] = perm[j], perm[i]
    return pts, perm.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _level_dims(h0: int, w0: int):
    return tuple(
        (int(round(h0 / SCALE_FACTOR**l)), int(round(w0 / SCALE_FACTOR**l)))
        for l in range(N_LEVELS)
    )


def _per_level_budget(total: int):
    """Geometric per-level feature budgets (OpenCV's distribution)."""
    q = 1.0 / SCALE_FACTOR
    raw = np.array([q**i for i in range(N_LEVELS)])
    raw = raw / raw.sum() * total
    budget = np.maximum(np.round(raw).astype(int), 1)
    budget[-1] = max(total - budget[:-1].sum(), 1)
    return [int(b) for b in budget]


def _bilinear_weight_mat(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] bilinear (antialiased triangle) resize weights — the per-axis
    weight matrix of jax.image.resize(..., method="bilinear") with
    scale = out/in and translation 0."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)  # antialias widens when downscaling
    sample_f = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[:, None] - np.arange(in_size)[None, :]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - x)
    total = weights.sum(axis=1, keepdims=True)
    weights = np.where(np.abs(total) > 1e-6, weights / total, 0.0)
    ok = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return (weights * ok[:, None]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pyramid_mats(h0: int, w0: int, device: torch.device):
    """Per level l >= 1: (Ry [h_l, h0], VxT [w0, w0]) with VxT's columns past
    w_l zero, so `Ry @ img @ VxT` is the level already padded to w0."""
    mats = []
    for h, w in _level_dims(h0, w0)[1:]:
        vxt = np.zeros((w0, w0), np.float32)
        vxt[:, :w] = _bilinear_weight_mat(w0, w).T
        mats.append(
            (
                torch.from_numpy(_bilinear_weight_mat(h0, h)).to(device),
                torch.from_numpy(vxt).to(device),
            )
        )
    return mats


def pyramid(img):
    """[H, W] f32 image -> [rows, W] row-stacked 8-level pyramid."""
    h0, w0 = img.shape
    levels = [img] + [
        Ry @ img @ VxT for Ry, VxT in _pyramid_mats(h0, w0, img.device)
    ]
    return torch.cat(levels)


@functools.lru_cache(maxsize=None)
def _kp_tables(h0: int, w0: int, max_features: int, device: torch.device):
    """Static per-slot tables of the level-major keypoint layout: the level
    row take [L, h0] (pad rows point one past the stack), the top-k slot
    selection, and per slot: level base row, h, w, scale, octave."""
    dims = _level_dims(h0, w0)
    budgets = _per_level_budget(max_features)
    row0, rows, _ = detect.level_layout(dims)
    take = np.full((N_LEVELS, h0), rows, np.int64)
    for l, (h, _) in enumerate(dims):
        take[l, :h] = row0[l] + np.arange(h)
    kmax = max(budgets)
    sel = np.concatenate([l * kmax + np.arange(b) for l, b in enumerate(budgets)])

    def rep(vals, dt):
        return torch.from_numpy(
            np.concatenate([np.full(b, v, dt) for v, b in zip(vals, budgets)])
        ).to(device)

    return (
        torch.from_numpy(take).to(device),
        torch.from_numpy(sel).to(device),
        kmax,
        rep(row0, np.int64),
        rep([h for h, _ in dims], np.int64),
        rep([w for _, w in dims], np.int64),
        rep([SCALE_FACTOR**l for l in range(N_LEVELS)], np.float32),
        rep(list(range(N_LEVELS)), np.int32),
    )


@functools.lru_cache(maxsize=None)
def _pattern(device: torch.device):
    pts, perm = _brief_pattern_np()
    pts = torch.from_numpy(pts).to(device)
    return pts[:, 0], pts[:, 1], torch.from_numpy(perm).long().to(device)


def pack_bits(bits):
    """bool [..., 256] -> int32 [..., 8]; bit i of word j is bits[32*j + i].
    Packed through int64 so that bit 31 lands as the int32 sign bit."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(*bits.shape[:-1], 8, 32).long() << shifts).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _post_detect(maps, h0: int, w0: int, max_features: int) -> Features:
    """Per-level top-k, subpixel peak, orientation and rBRIEF over the
    row-stacked detection maps."""
    dev = maps.score.device
    take, sel, kmax, base, hl, wl, scale, octave = _kp_tables(
        h0, w0, max_features, dev
    )
    W = maps.score.shape[1]
    neg = torch.full((1, W), -torch.inf, dtype=maps.score.dtype, device=dev)
    seg = torch.cat([maps.score, neg])[take].reshape(N_LEVELS, h0 * W)
    vals_b, flat_b = torch.topk(seg, kmax, dim=1)
    vals = vals_b.reshape(-1)[sel]
    flat = flat_b.reshape(-1)[sel]
    valid = torch.isfinite(vals)
    # invalid slots (fewer corners than budget) may point past their level:
    # clip them in, as the JAX package's clamped gathers do
    ys = torch.minimum(flat // W, hl - 1)
    xs = torch.minimum(flat - (flat // W) * W, wl - 1)

    # subpixel peak refinement on the raw Harris surface (quadratic fit per
    # axis, offset clamped to +-0.5)
    hf = maps.harris.reshape(-1)

    def at(dy, dx):
        yy = base + torch.clamp(ys + dy, min=0).minimum(hl - 1)
        xx = torch.clamp(xs + dx, min=0).minimum(wl - 1)
        return hf[yy * W + xx]

    c0 = at(0, 0)

    def offset(m, p):
        denom = m - 2.0 * c0 + p
        denom = torch.where(torch.abs(denom) < 1e-12, 1.0, denom)
        return torch.clamp(0.5 * (m - p) / denom, -0.5, 0.5)

    xs_f = xs.to(torch.float32) + offset(at(0, -1), at(0, 1))
    ys_f = ys.to(torch.float32) + offset(at(-1, 0), at(1, 0))

    flat_map = (base + ys) * W + xs
    ang = torch.atan2(maps.m01.reshape(-1)[flat_map], maps.m10.reshape(-1)[flat_map])

    # rBRIEF: 256 rotated samples of the blur rounded to integers (half to
    # even, as jnp.round), bit i = sample[i] < sample[perm[i]]
    py, px, perm = _pattern(dev)
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    rx = torch.round(px[None] * c - py[None] * s).long()
    ry = torch.round(px[None] * s + py[None] * c).long()
    sx = torch.clamp(xs[:, None] + rx, min=0).minimum(wl[:, None] - 1)
    sy = torch.clamp(ys[:, None] + ry, min=0).minimum(hl[:, None] - 1)
    samples = torch.round(maps.blur.reshape(-1)[(base[:, None] + sy) * W + sx])
    desc = pack_bits(samples < samples[:, perm])

    return Features(
        xy=torch.stack([xs_f, ys_f], -1) * scale[:, None],
        angle=ang,
        desc=desc,
        score=torch.where(valid, vals, -torch.inf),
        valid=valid,
        octave=octave,
    )


def extract(
    img, max_features: int, fast_threshold: float = 20.0, per_level: bool = False
) -> Features:
    """ORB features over an 8-level pyramid. img: [H, W] grayscale.

    Returns exactly sum(_per_level_budget(max_features)) slots, level-major,
    with a validity mask. Runs on the device of `img`.

    `per_level=True` is the counterpart of the JAX package's
    `extract(use_fused=True, onehot_desc=False)`: the detection maps come
    from one launch per pyramid level at the level's own size (the Hopper
    form of `pallas_detect.detect_stage`), then the same top-k, subpixel,
    orientation and rBRIEF steps. It gives the same Features as the default
    one-launch path: the maps agree wherever a feature reads them.
    """
    img = img.to(torch.float32)
    h0, w0 = img.shape
    detect_fn = detect.detect_maps_per_level if per_level else detect.detect_maps
    maps = detect_fn(pyramid(img), _level_dims(h0, w0), fast_threshold, BORDER)
    return _post_detect(maps, h0, w0, max_features)
