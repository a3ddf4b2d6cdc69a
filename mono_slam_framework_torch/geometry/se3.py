"""SE(3) utilities: exp/log maps, inverses, quaternion conversions.

PyTorch counterpart of `mono_slam_framework_tpu/geometry/se3.py`. Functions
take tensors with any leading batch dims and keep their dtype, so the same
code runs f32 on the card and f64 in parity tests.

Convention: ``T`` is a 4x4 world->camera transform (the reference's
``mTcw``); tangent vectors are ``[omega, upsilon]`` (rotation first), the
g2o SE3Quat::exp ordering.
"""

from __future__ import annotations

import torch

# Taylor branch below theta = 0.05: in f32 the closed forms cancel
# catastrophically well before that (1 - cos(1.3e-4) is exactly 0 in f32).
SMALL_THETA2 = 2.5e-3


def hat(w):
    """Skew-symmetric matrix of a 3-vector."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _sinc_coeffs(theta2):
    """Taylor-safe (A, B, C) = (sin t/t, (1-cos t)/t^2, (1 - A)/t^2)."""
    small = theta2 < SMALL_THETA2
    theta = torch.sqrt(theta2)
    th = torch.where(small, torch.ones_like(theta), theta)
    t2 = theta2
    A = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, torch.sin(th) / th)
    B = torch.where(
        small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0, (1.0 - torch.cos(th)) / t2
    )
    C = torch.where(
        small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0, (1.0 - A) / t2
    )
    return A, B, C


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def orthonormalize(T):
    """Project the rotation block of a [..., 4, 4] transform onto SO(3).

    Two Newton steps of the polar decomposition (R <- 1.5 R - 0.5 R R^T R),
    as g2o's SE3Quat storage returns an exactly orthonormal rotation.
    """
    R = T[..., :3, :3]
    for _ in range(2):
        R = 1.5 * R - 0.5 * R @ R.transpose(-1, -2) @ R
    out = T.clone()
    out[..., :3, :3] = R
    return out


def log_so3(R):
    """3x3 rotation -> 3-vector (angle-axis), atan2 form."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    vee = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    s2 = 0.25 * torch.sum(vee * vee, dim=-1)  # sin^2(theta)
    small = s2 < 1e-12
    sin_t = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    theta = torch.atan2(sin_t, cos_t)
    scale = torch.where(small, 0.5 + s2 / 12.0, theta / (2.0 * sin_t))
    return scale[..., None] * vee


def exp_se3(xi):
    """Tangent [omega(3), upsilon(3)] -> 4x4 transform (g2o ordering)."""
    w = xi[..., :3]
    v = xi[..., 3:]
    A, B, C = _sinc_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    W2 = W @ W
    I = _eye3(xi)
    R = I + A[..., None, None] * W + B[..., None, None] * W2
    V = I + B[..., None, None] * W + C[..., None, None] * W2
    return _from_rt(R, V @ v[..., None])


def log_se3(T):
    """4x4 transform -> tangent [omega, upsilon]."""
    t = T[..., :3, 3]
    w = log_so3(T[..., :3, :3])
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_coeffs(theta2)
    W = hat(w)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2, Taylor below 0.05
    small = theta2 < SMALL_THETA2
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    Bs = torch.where(small, torch.ones_like(B), B)
    coef = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
        (1.0 - A / (2.0 * Bs)) / t2,
    )
    Vinv = _eye3(T) - 0.5 * W + coef[..., None, None] * (W @ W)
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def _from_rt(R, t):
    """[..., 3, 3] rotation and [..., 3, 1] translation -> [..., 4, 4]. Built
    by concatenation: writing a Python scalar into a CUDA tensor copies it
    from the host and synchronizes."""
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:]
    return torch.cat([torch.cat([R, t], -1), bottom.expand(*R.shape[:-2], 1, 4)], -2)


def compose(Ta, Tb):
    """Ta @ Tb over any leading batch dims."""
    return Ta @ Tb


def inverse(T):
    """Exact SE3 inverse."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _from_rt(Rt, -(Rt @ T[..., :3, 3:]))


def camera_center(Tcw):
    """World coordinates of the camera center Ow = -Rcw^T tcw."""
    return -(Tcw[..., :3, :3].transpose(-1, -2) @ Tcw[..., :3, 3:])[..., 0]


def rotation_to_quaternion(R):
    """3x3 rotation -> quaternion [qx, qy, qz, qw] (TUM export order).

    Shepperd's method: four candidate constructions, the best-conditioned
    one picked per matrix; sign canonicalized to qw >= 0.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def mk(a, b, c, d):
        return torch.stack([a, b, c, d], dim=-1)

    q0 = mk(m21 - m12, m02 - m20, m10 - m01, 1.0 + tr)  # w-major
    q1 = mk(1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12)  # x-major
    q2 = mk(m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20)  # y-major
    q3 = mk(m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01)  # z-major
    s = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
         1.0 - m00 - m11 + m22],
        dim=-1,
    )
    idx = torch.argmax(s, dim=-1)[..., None]
    q = torch.where(
        idx == 0, q0, torch.where(idx == 1, q1, torch.where(idx == 2, q2, q3))
    )
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)
