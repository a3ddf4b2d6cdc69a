"""The synthetic camera world of the benchmark, rendered on the device.

Frozen copy, ported to torch, of `mono_slam_framework_torch/sim.py:18-198`
(`PlaneWorld`: the "kron" texture and `render`) and of
`sim.py:227-248` (`lateral_trajectory`'s pose form). The copy lives here so
that an edit of the program's simulator cannot move the benchmark's inputs.
Differences from the source: the texture's random draws come from one
`numpy.random.Generator` seeded by the benchmark (its size and square count
are parameters), the camera has its own fx, fy, cx, cy, and a batch of poses
is rendered in one pass on any device.

A world is textured planes facing the camera: the primary plane at
`plane_z`, and extra planes `(z, threshold, axis)` applied in order, each
taking over where the ray's hit on it lies past its threshold along `axis`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

AXES = ("x", "-x", "y", "-y")


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for (seed, stream...): any whole number, negative or past
    64 bits, is taken modulo 2**64."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2**64, *stream]))


def kron_texture(rng: np.random.Generator, size: int, squares: int) -> np.ndarray:
    """sim.PlaneWorld's "kron" texture: a random 16-texel grid, then
    `squares` high-contrast squares of 6-19 texels, drawn in order."""
    coarse = rng.uniform(0, 255, (size // 16, size // 16))
    tex = np.kron(coarse, np.ones((16, 16)))
    for _ in range(squares):
        y = rng.integers(0, size - 24)
        x = rng.integers(0, size - 24)
        s = rng.integers(6, 20)
        tex[y : y + s, x : x + s] = rng.uniform(0, 255)
    return tex.astype(np.float32)


class World:
    def __init__(self, width: int, height: int, fx: float, fy: float, cx: float, cy: float,
                 plane_z: float, planes, texture: np.ndarray, tex_scale: float,
                 device: torch.device):
        self.w, self.h, self.cx, self.cy = width, height, cx, cy
        self.fx, self.fy = fx, fy
        self.plane_z = float(plane_z)
        self.planes = [(float(p[0]), float(p[1]), p[2] if len(p) > 2 else "x") for p in planes]
        for p in self.planes:
            if p[2] not in AXES:
                raise ValueError(f"unknown plane axis {p[2]!r} in {p}")
        self.tex = torch.from_numpy(texture).to(device)
        self.tex_size = texture.shape[0]
        self.tex_scale = float(tex_scale)
        self.device = device

    def render(self, Tcw: np.ndarray) -> torch.Tensor:
        """[B, H, W] f32 views from world->camera poses Tcw [B, 4, 4]
        (sim.PlaneWorld.render over a batch; rays in float64)."""
        dev = self.device
        T = torch.as_tensor(np.asarray(Tcw, np.float64), device=dev)
        Rwc = T[:, :3, :3].transpose(1, 2)
        Ow = -(Rwc @ T[:, :3, 3:])[..., 0]  # [B, 3]
        vv, uu = torch.meshgrid(torch.arange(self.h, device=dev, dtype=torch.float64),
                                torch.arange(self.w, device=dev, dtype=torch.float64),
                                indexing="ij")
        d_cam = torch.stack([(uu - self.cx) / self.fx, (vv - self.cy) / self.fy,
                             torch.ones_like(uu)], dim=-1)  # [H, W, 3]
        d_world = torch.einsum("hwk,bjk->bhwj", d_cam, Rwc)
        dz = d_world[..., 2]
        dz = torch.where(dz.abs() < 1e-9, torch.full_like(dz, 1e-9), dz)
        ox, oy, oz = (Ow[:, k, None, None] for k in range(3))
        t = (self.plane_z - oz) / dz
        px = ox + t * d_world[..., 0]
        py = oy + t * d_world[..., 1]
        for z2, th, ax in self.planes:
            t2 = (z2 - oz) / dz
            px2 = ox + t2 * d_world[..., 0]
            py2 = oy + t2 * d_world[..., 1]
            use2 = {"x": px2 > th, "-x": px2 < th, "y": py2 > th, "-y": py2 < th}[ax]
            t = torch.where(use2, t2, t)
            px = torch.where(use2, px2, px)
            py = torch.where(use2, py2, py)
        n = self.tex_size
        tx = px * self.tex_scale + n / 2.0
        ty = py * self.tex_scale + n / 2.0
        x0 = torch.clamp(torch.floor(tx), 0, n - 2)
        y0 = torch.clamp(torch.floor(ty), 0, n - 2)
        fx = torch.clamp(tx - x0, 0, 1).float()
        fy = torch.clamp(ty - y0, 0, 1).float()
        x0, y0 = x0.long(), y0.long()
        tex = self.tex
        img = (tex[y0, x0] * (1 - fx) * (1 - fy) + tex[y0, x0 + 1] * fx * (1 - fy)
               + tex[y0 + 1, x0] * (1 - fx) * fy + tex[y0 + 1, x0 + 1] * fx * fy)
        return torch.where(t > 0, img, torch.full_like(img, 128.0))

    def render_host(self, Tcw: np.ndarray, chunk: int = 32) -> list[np.ndarray]:
        """Each view as a host [H, W] f32 array, rendered `chunk` at a time."""
        out: list[np.ndarray] = []
        for i in range(0, len(Tcw), chunk):
            out.extend(self.render(Tcw[i : i + chunk]).cpu().numpy())
        return out


def translation_poses(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """World->camera poses [N, 4, 4] f32 of a camera facing +z at centres
    (x, y, 0) (lateral_trajectory with no yaw)."""
    T = np.tile(np.eye(4), (len(x), 1, 1))
    T[:, 0, 3] = -np.asarray(x, np.float64)
    T[:, 1, 3] = -np.asarray(y, np.float64)
    return T.astype(np.float32)


def path_centres(path: dict, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Camera centres (x, y) of frames 0..n-1 of a path description:
    {"kind": "cosine", "amplitude": a, "period": p} gives
    x(i) = a (1 - cos(2 pi i / p)); {"kind": "line", "start": x0,
    "step": s} gives x(i) = x0 + s i. Both take y(i) = jitter * (i mod
    jitter_period) (lateral_trajectory's y)."""
    i = np.arange(n, dtype=np.float64)
    if path["kind"] == "cosine":
        x = path["amplitude"] * (1.0 - np.cos(2.0 * math.pi * i / path["period"]))
    elif path["kind"] == "line":
        x = path["start"] + path["step"] * i
    else:
        raise ValueError(f"unknown path kind {path['kind']!r}")
    y = path.get("jitter", 0.0) * (i % path.get("jitter_period", 1))
    return x, y
