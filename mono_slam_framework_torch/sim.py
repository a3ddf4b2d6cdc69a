"""Procedural camera simulator: the framework's Webots-world stand-in.

The reference application runs inside a Webots robot simulation whose camera
feeds the pipeline (src/main.cpp:50-59, 122-128). This module is the rebuild's
equivalent world: it renders geometrically consistent views of textured planes
from arbitrary camera poses (primary plane at z = plane_z in world coords,
camera looking +z), so ground-truth trajectories come for free. It backs the
pipeline integration tests and the port's chip smoke drive (`chip_smoke.py`).
A copy of `mono_slam_framework_tpu/sim.py` (numpy only), except that an
unknown plane-axis string raises instead of acting as "-y".
"""

from __future__ import annotations

import numpy as np


class PlaneWorld:
    def __init__(
        self,
        width=320,
        height=240,
        f=250.0,
        plane_z=5.0,
        second_plane=(3.5, 0.9),  # (z, world-x threshold) or None for planar
        tex_size=2048,
        tex_scale=100.0,  # texture pixels per world unit
        seed=7,
        texture="kron",  # "kron" (8px-lattice corners) | "smooth" (off-grid)
    ):
        self.w, self.h, self.f = width, height, f
        self.cx, self.cy = width / 2.0, height / 2.0
        self.plane_z = plane_z
        # Closer planes past a world threshold break the planar two-view
        # degeneracy (a single plane admits the homography ambiguity family,
        # and a DOMINANT plane makes 8-point F estimation ill-conditioned).
        # `second_plane` may be one (z, x_threshold) pair or a list of
        # entries, applied in order (each overrides where it applies):
        #   (z, th)        — plane z for world x > th
        #   (z, th, "y")   — plane z for world y > th
        #   (z, th, "-y")  — plane z for world y < th (likewise "-x")
        # Axis-mixed entries matter for 2-D trajectories (the rect-loop
        # quality world): with x-only structure, a leg moving along y sees a
        # SINGLE fronto-parallel plane — monocular pose estimation against
        # young two-observation points is ill-conditioned there and the leg
        # collapses (tools/tpu_axis_probe.py corner arms, round 5).
        if second_plane is None:
            self.extra_planes = []
        elif isinstance(second_plane, tuple):
            self.extra_planes = [second_plane]
        else:
            self.extra_planes = list(second_plane)
        self.extra_planes = [
            (e[0], e[1], e[2] if len(e) > 2 else "x") for e in self.extra_planes
        ]
        for e in self.extra_planes:
            if e[2] not in ("x", "-x", "y", "-y"):
                raise ValueError(f"unknown plane axis {e[2]!r} in {e}")
        self.tex_scale = tex_scale
        rng = np.random.default_rng(seed)
        if texture == "smooth":
            # OFF-LATTICE texture: the kron texture's block edges land on an
            # 8-image-px lattice under the standard fronto-parallel setup
            # (f/(z*tex_scale) = 0.5 px/texel), which hides subpixel errors
            # (KNOWN_ISSUES.md). Here the base field is bilinear noise at an
            # irrational texel pitch and the corner-rich blobs are ROTATED
            # squares at float positions, so no corner sits on any lattice.
            yy, xx = np.meshgrid(
                np.arange(tex_size), np.arange(tex_size), indexing="ij"
            )

            def _bilin_noise(pitch, lo, hi, n, sd):
                g = np.random.default_rng(sd).uniform(lo, hi, (n, n))
                sy = yy / pitch
                sx = xx / pitch
                y0 = np.floor(sy).astype(int) % (n - 1)
                x0 = np.floor(sx).astype(int) % (n - 1)
                fy = (sy - np.floor(sy)).astype(np.float32)
                fx = (sx - np.floor(sx)).astype(np.float32)
                return (
                    g[y0, x0] * (1 - fx) * (1 - fy)
                    + g[y0, x0 + 1] * fx * (1 - fy)
                    + g[y0 + 1, x0] * (1 - fx) * fy
                    + g[y0 + 1, x0 + 1] * fx * fy
                )

            tex = _bilin_noise(16.37, 40, 215, 160, seed)
            for _ in range(900):
                cy = rng.uniform(20, tex_size - 20)
                cx_ = rng.uniform(20, tex_size - 20)
                s = rng.uniform(5, 16)
                a = rng.uniform(0, np.pi)
                level = rng.uniform(0, 255)
                r = int(np.ceil(s * 0.75)) + 2
                ylo, yhi = int(cy) - r, int(cy) + r + 1
                xlo, xhi = int(cx_) - r, int(cx_) + r + 1
                py, px = np.meshgrid(
                    np.arange(ylo, yhi) - cy,
                    np.arange(xlo, xhi) - cx_,
                    indexing="ij",
                )
                ca, sa = np.cos(a), np.sin(a)
                u = ca * px + sa * py
                v = -sa * px + ca * py
                mask = (np.abs(u) <= s / 2) & (np.abs(v) <= s / 2)
                tex[ylo:yhi, xlo:xhi][mask] = level
            # fine decorrelation layer over everything (blobs included):
            # without it the rotated blobs are too self-similar and the
            # Lowe ratio test rejects most matches (descriptor ambiguity)
            tex = np.clip(
                tex + _bilin_noise(3.71, -30, 30, 640, seed + 1), 0, 255
            )
        else:
            # feature-rich blocky texture: upsampled random grid + salt blocks
            coarse = rng.uniform(0, 255, (tex_size // 16, tex_size // 16))
            tex = np.kron(coarse, np.ones((16, 16)))
            # add high-contrast corner-rich squares
            for _ in range(400):
                y = rng.integers(0, tex_size - 24)
                x = rng.integers(0, tex_size - 24)
                s = rng.integers(6, 20)
                tex[y : y + s, x : x + s] = rng.uniform(0, 255)
        self.tex = tex.astype(np.float32)
        self.tex_size = tex_size

    @property
    def K(self):
        return np.array(
            [[self.f, 0, self.cx], [0, self.f, self.cy], [0, 0, 1]], np.float32
        )

    def render(self, Tcw: np.ndarray) -> np.ndarray:
        """[H,W] f32 view of the plane from world->camera pose Tcw."""
        Rcw = Tcw[:3, :3]
        tcw = Tcw[:3, 3]
        Rwc = Rcw.T
        Ow = -Rwc @ tcw
        uu, vv = np.meshgrid(np.arange(self.w), np.arange(self.h))
        d_cam = np.stack(
            [(uu - self.cx) / self.f, (vv - self.cy) / self.f, np.ones_like(uu)],
            axis=-1,
        ).astype(np.float64)
        d_world = d_cam @ Rwc.T
        dz = d_world[..., 2]
        dz = np.where(np.abs(dz) < 1e-9, 1e-9, dz)
        t = (self.plane_z - Ow[2]) / dz
        px = Ow[0] + t * d_world[..., 0]
        py = Ow[1] + t * d_world[..., 1]
        for z2, th, ax in self.extra_planes:
            t2 = (z2 - Ow[2]) / dz
            px2 = Ow[0] + t2 * d_world[..., 0]
            py2 = Ow[1] + t2 * d_world[..., 1]
            if ax == "x":
                use2 = px2 > th
            elif ax == "-x":
                use2 = px2 < th
            elif ax == "y":
                use2 = py2 > th
            else:  # "-y"
                use2 = py2 < th
            t = np.where(use2, t2, t)
            px = np.where(use2, px2, px)
            py = np.where(use2, py2, py)
        tx = px * self.tex_scale + self.tex_size / 2.0
        ty = py * self.tex_scale + self.tex_size / 2.0
        # bilinear sample with border clamp
        x0 = np.clip(np.floor(tx).astype(int), 0, self.tex_size - 2)
        y0 = np.clip(np.floor(ty).astype(int), 0, self.tex_size - 2)
        fx = np.clip(tx - x0, 0, 1)
        fy = np.clip(ty - y0, 0, 1)
        tex = self.tex
        img = (
            tex[y0, x0] * (1 - fx) * (1 - fy)
            + tex[y0, x0 + 1] * fx * (1 - fy)
            + tex[y0 + 1, x0] * (1 - fx) * fy
            + tex[y0 + 1, x0 + 1] * fx * fy
        )
        # invalid (behind camera) -> mid gray
        img = np.where(t > 0, img, 128.0)
        return img.astype(np.float32)


# Depth structure for the rect-loop quality world: boundaries along BOTH
# axes so every leg of the 3.0 x 2.2 loop keeps at least one depth
# discontinuity in view (viewport ~2.6 x 1.9 at z=2). With x-only structure
# the +y legs see a single fronto-parallel plane and monocular tracking
# collapses a few keyframes past the corner (far-point triangulations make
# rotation explain flow; measured in tools/tpu_axis_probe.py, round 5). The
# reference app's Webots scene is fully 3-D (worlds/slam.wbt), so 2-D-varying
# depth is the faithful stand-in, not a concession.
RECT_LOOP_PLANES = [
    (2.3, -0.9, "x"),
    (1.7, 0.3, "x"),
    (2.2, 1.1, "y"),
    (2.1, 2.2, "x"),
    (1.8, 1.6, "y"),
]


def rect_loop_trajectory(lx: float, ly: float, step: float):
    """Rectangular 'lawnmower' loop in the x-y plane, camera always facing
    +z: right along y=0, up, left along y=ly, back down to the start. With
    ly larger than the viewport height the return strip shares no view with
    the outbound strip, so a SLAM run double-maps the start area and the
    final descent produces a genuine loop-closure situation (image match
    without covisibility)."""
    waypoints = [
        (0.0, 0.0),
        (lx, 0.0),
        (lx, ly),
        (0.0, ly),
        (0.0, 0.0),
    ]
    centers = []
    for (x0, y0), (x1, y1) in zip(waypoints[:-1], waypoints[1:]):
        seg = np.hypot(x1 - x0, y1 - y0)
        n = max(2, int(np.ceil(seg / step)))
        for i in range(n):
            t = i / n
            centers.append((x0 + t * (x1 - x0), y0 + t * (y1 - y0)))
    centers.append((0.0, 0.0))
    poses = []
    for cx_, cy_ in centers:
        Tcw = np.eye(4)
        Tcw[:3, 3] = [-cx_, -cy_, 0.0]
        poses.append(Tcw.astype(np.float32))
    return poses


def lateral_trajectory(n_frames: int, step: float = 0.06, yaw_step: float = 0.0):
    """Ground-truth world->camera poses for a laterally translating camera."""
    poses = []
    for i in range(n_frames):
        yaw = yaw_step * i
        R = np.array(
            [
                [np.cos(yaw), 0, np.sin(yaw)],
                [0, 1, 0],
                [-np.sin(yaw), 0, np.cos(yaw)],
            ],
            np.float64,
        )
        Ow = np.array([i * step, 0.015 * (i % 3), 0.0])
        Tcw = np.eye(4)
        Tcw[:3, :3] = R
        Tcw[:3, 3] = -R @ Ow
        poses.append(Tcw.astype(np.float32))
    return poses
