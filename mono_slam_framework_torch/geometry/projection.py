"""Pinhole projection / backprojection and batched frustum tests.

PyTorch counterpart of `mono_slam_framework_tpu/geometry/projection.py`:
the per-point loops of Frame::isInFrustum (slam_pipeline/src/Frame.cc:48-84)
as one vectorized pass over all map points. Functions keep the dtype and
device of their inputs.
"""

from __future__ import annotations

import torch


def project(X_cam, K):
    """Project camera-frame 3D points to pixels. X_cam [..., 3], K [3,3]."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    z = X_cam[..., 2]
    safe_z = torch.where(z == 0, torch.ones_like(z), z)
    u = fx * X_cam[..., 0] / safe_z + cx
    v = fy * X_cam[..., 1] / safe_z + cy
    return torch.stack([u, v], dim=-1)


def transform_points(Tcw, X_world):
    """World -> camera frame. Tcw [..., 4, 4], X_world [..., N, 3]."""
    R = Tcw[..., :3, :3]
    t = Tcw[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, X_world) + t[..., None, :]


def backproject(uv, K):
    """Pixels -> normalized camera rays (z = 1). uv [..., 2]."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def in_frustum(Tcw, K, X_world, normals, max_dist, width, height,
               viewing_cos_limit=0.5):
    """Vectorized Frame::isInFrustum (Frame.cc:48-84) over all map points.

    Args:
      Tcw: [4,4] camera pose.
      K: [3,3] intrinsics.
      X_world: [N,3] map point positions.
      normals: [N,3] mean viewing directions (MapPoint::GetNormal).
      max_dist: [N] distance-invariance bound (1.2 * mfDistance,
        MapPoint.cc:222).
      width, height: image bounds (FrameBase.cc:10-13: min=0, max=cols/rows).
      viewing_cos_limit: the reference passes 0.5 (Tracking.cc:612).

    Returns:
      bool [N] visibility mask.
    """
    Xc = transform_points(Tcw, X_world[None])[0]
    z_ok = Xc[..., 2] >= 0.0  # reference: PcZ < 0 -> reject (Frame.cc:59)
    uv = project(Xc, K)
    u, v = uv[..., 0], uv[..., 1]
    in_img = (u >= 0.0) & (u <= width) & (v >= 0.0) & (v <= height)
    Ow = -torch.einsum("ji,j->i", Tcw[:3, :3], Tcw[:3, 3])
    PO = X_world - Ow
    dist = torch.linalg.norm(PO, dim=-1)
    dist_ok = dist <= max_dist
    safe_dist = torch.where(dist == 0, torch.ones_like(dist), dist)
    view_cos = torch.sum(PO * normals, dim=-1) / safe_dist
    cos_ok = view_cos >= viewing_cos_limit
    return z_ok & in_img & dist_ok & cos_ok
