"""Batched DLT triangulation.

PyTorch counterpart of `mono_slam_framework_tpu/geometry/triangulation.py`
(Initializer::Triangulate, Initializer.cc:744-758, and the inline 4x4-SVD
triangulation of LocalMapping::CreateNewMapPoints, LocalMapping.cc:211-227):
one call triangulates every correspondence. Every function takes optional
leading batch dims, so the JAX package's `vmap` over keyframe pairs
(`triangulate_gated_many`) is the same function with a batch axis.
"""

from __future__ import annotations

import torch


def _intrinsics(K):
    """(fx, fy, cx, cy) of [..., 3, 3] intrinsics, each [..., 1] so that it
    broadcasts over a point axis."""
    return (K[..., 0, 0, None], K[..., 1, 1, None], K[..., 0, 2, None],
            K[..., 1, 2, None])


def triangulate_dlt(uv1, uv2, P1, P2):
    """Linear triangulation of pixel correspondences.

    Args:
      uv1, uv2: [..., N, 2] pixel (or normalized) coordinates in image 1/2.
      P1, P2: [..., 3, 4] projection matrices for the matching coordinate space.

    Returns:
      X: [..., N, 3] euclidean points, w: [..., N] homogeneous scale (w == 0
      means the solve degenerated; the caller must mask, mirroring
      LocalMapping.cc:224).
    """
    P1, P2 = P1[..., None, :, :], P2[..., None, :, :]
    # A rows: u*P[2] - P[0], v*P[2] - P[1] for each view
    a0 = uv1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :]
    a1 = uv1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :]
    a2 = uv2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :]
    a3 = uv2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :]
    A = torch.stack(torch.broadcast_tensors(a0, a1, a2, a3), dim=-2)  # [..., N, 4, 4]
    # null vector of A = the last right-singular vector
    Xh = torch.linalg.svd(A)[2][..., 3, :]  # [..., N, 4]
    w = Xh[..., 3]
    safe_w = torch.where(w == 0, torch.ones_like(w), w)
    return Xh[..., :3] / safe_w[..., None], w


def rays_cos_parallax(uv1, uv2, K1, K2, Rwc1, Rwc2):
    """cos of the angle between the backprojected world rays of each match
    (the parallax gate of LocalMapping.cc:199-211)."""
    fx1, fy1, cx1, cy1 = _intrinsics(K1)
    fx2, fy2, cx2, cy2 = _intrinsics(K2)
    one = torch.ones_like(uv1[..., 0])
    xn1 = torch.stack([(uv1[..., 0] - cx1) / fx1, (uv1[..., 1] - cy1) / fy1, one], -1)
    xn2 = torch.stack([(uv2[..., 0] - cx2) / fx2, (uv2[..., 1] - cy2) / fy2, one], -1)
    ray1 = xn1 @ Rwc1.transpose(-1, -2)
    ray2 = xn2 @ Rwc2.transpose(-1, -2)
    denom = torch.linalg.norm(ray1, dim=-1) * torch.linalg.norm(ray2, dim=-1)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    return torch.sum(ray1 * ray2, dim=-1) / denom


def triangulate_gated(uv1, uv2, valid, K1, K2, Tcw1, Tcw2, min_parallax):
    """The CreateNewMapPoints stage (LocalMapping.cc:199-264): parallax gate
    on backprojected rays, normalized-coordinate DLT, cheirality and chi2
    reprojection gates.

    uv1, uv2 [..., N, 2], valid bool [..., N], K1/K2 [..., 3, 3],
    Tcw1/Tcw2 [..., 4, 4]; leading dims broadcast.
    Returns (X [..., N, 3] world points, ok bool [..., N]).
    """
    R1, t1 = Tcw1[..., :3, :3], Tcw1[..., :3, 3]
    R2, t2 = Tcw2[..., :3, :3], Tcw2[..., :3, 3]
    cosp = rays_cos_parallax(
        uv1, uv2, K1, K2, R1.transpose(-1, -2), R2.transpose(-1, -2)
    )
    gate = (cosp > 0) & (cosp < min_parallax)

    fx1, fy1, cx1, cy1 = _intrinsics(K1)
    fx2, fy2, cx2, cy2 = _intrinsics(K2)
    xn1 = torch.stack([(uv1[..., 0] - cx1) / fx1, (uv1[..., 1] - cy1) / fy1], -1)
    xn2 = torch.stack([(uv2[..., 0] - cx2) / fx2, (uv2[..., 1] - cy2) / fy2], -1)
    P1 = torch.cat([R1, t1[..., None]], dim=-1)
    P2 = torch.cat([R2, t2[..., None]], dim=-1)
    X, w_h = triangulate_dlt(xn1, xn2, P1, P2)

    Xc1 = X @ R1.transpose(-1, -2) + t1[..., None, :]
    Xc2 = X @ R2.transpose(-1, -2) + t2[..., None, :]
    z1, z2 = Xc1[..., 2], Xc2[..., 2]
    zs1 = torch.where(z1 == 0, torch.ones_like(z1), z1)
    zs2 = torch.where(z2 == 0, torch.ones_like(z2), z2)
    e1 = (fx1 * Xc1[..., 0] / zs1 + cx1 - uv1[..., 0]) ** 2 + (
        fy1 * Xc1[..., 1] / zs1 + cy1 - uv1[..., 1]
    ) ** 2
    e2 = (fx2 * Xc2[..., 0] / zs2 + cx2 - uv2[..., 0]) ** 2 + (
        fy2 * Xc2[..., 1] / zs2 + cy2 - uv2[..., 1]
    ) ** 2
    ok = (
        valid
        & gate
        & (w_h != 0)
        & (z1 > 0)
        & (z2 > 0)
        & (e1 <= 5.991)
        & (e2 <= 5.991)
        & torch.isfinite(X).all(dim=-1)
    )
    return X, ok


def triangulate_gated_many(uv1, uv2, valid, K1, K2, Tcw1, Tcw2, min_parallax):
    """`triangulate_gated` over B keyframe pairs in one call: uv1/uv2
    [B, m, 2], valid [B, m], K2 [B, 3, 3], Tcw2 [B, 4, 4] per pair; K1 [3, 3]
    and Tcw1 [4, 4] shared (the JAX package's vmap with in_axes
    (0, 0, 0, None, 0, None, 0, None))."""
    return triangulate_gated(uv1, uv2, valid, K1, K2, Tcw1, Tcw2, min_parallax)
