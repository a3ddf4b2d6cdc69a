"""Side-by-side match visualization.

A copy of `mono_slam_framework_tpu/viz/match_image.py` (numpy only).

Capability twin of Tracking::CreateCurrentMatchImage (src/Tracking.cc:899-940):
the two frame images side by side in RGB with filled radius-3 circles — green
for brand-new matches (neither pixel has a map point) drawn first, then
colored (reference uses (255,0,0)) for matches where either side already has
a map point. Always rebuilt per matcher call (reference quirk B6 — it is part
of the public API surface via System::GetCurrentMatchImage).

Pure numpy host rendering (display is not a device workload).
"""

from __future__ import annotations

import numpy as np

RADIUS = 3
COLOR_NEW = (0, 255, 0)
COLOR_WITH_MP = (255, 0, 0)

_dy, _dx = np.mgrid[-RADIUS : RADIUS + 1, -RADIUS : RADIUS + 1]
_disk = (_dy**2 + _dx**2) <= RADIUS**2
_DISK_OFF = np.stack([_dy[_disk], _dx[_disk]], axis=-1)  # [K,2] (dy,dx)


def _to_u8(img) -> np.ndarray:
    a = np.asarray(img)
    return np.clip(a, 0, 255).astype(np.uint8)


def _draw_circles(canvas: np.ndarray, pts: np.ndarray, color) -> None:
    """Filled circles at integer (x, y) points; vectorized scatter."""
    if len(pts) == 0:
        return
    h, w, _ = canvas.shape
    centers = pts[:, None, ::-1] + _DISK_OFF[None]  # [N,K,2] as (y,x)
    ys = centers[..., 0].ravel()
    xs = centers[..., 1].ravel()
    ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    canvas[ys[ok], xs[ok]] = color


def render_match_image(match_result, has_mp=None) -> np.ndarray:
    """[H, 2W, 3] uint8 side-by-side visualization of a MatchFramesResult.

    `has_mp` (bool [num_matches], optional) pre-classifies matches; when
    omitted it is derived through the per-match map lookups."""
    img1 = _to_u8(match_result.frame1.image)
    img2 = _to_u8(match_result.frame2.image)
    h, w = img1.shape
    canvas = np.empty((h, 2 * w, 3), np.uint8)
    canvas[:, :w] = img1[..., None]
    canvas[:, w:] = img2[..., None]

    n = match_result.num_matches
    if n:
        if has_mp is None:
            has_mp = np.zeros(n, bool)
            for i in range(n):
                has_mp[i] = (
                    match_result.get_map_point1(i) is not None
                    or match_result.get_map_point2(i) is not None
                )
        else:
            has_mp = np.asarray(has_mp, bool)
        kp1 = match_result.keypoints1
        kp2 = match_result.keypoints2.copy()
        kp2[:, 0] += w
        # new matches first, then map-point matches on top (Tracking.cc:910-939)
        _draw_circles(canvas, kp1[~has_mp], COLOR_NEW)
        _draw_circles(canvas, kp2[~has_mp], COLOR_NEW)
        _draw_circles(canvas, kp1[has_mp], COLOR_WITH_MP)
        _draw_circles(canvas, kp2[has_mp], COLOR_WITH_MP)
    return canvas
