"""Plain reference of kernel B2: motion-only pose LM over a batch of problems.

Frozen copy, batched over a leading problem axis, of the plain path the
program's kernel B2 computes: `mono_slam_framework_torch/optim/pose_opt.py:
35-131` (`_edge_terms`, `_normal_eqs`, `_round`, `pose_optimize_plain`),
`optim/lm.py:29-74` (Huber weight and rho, Nielsen update, the projection
and point Jacobians) and `geometry/se3.py:18-140` (`exp_se3`,
`orthonormalize`). The schedule is the reference's PoseOptimization
(Optimizer.cc:217-334): 4 rounds of 10 LM iterations, each round restarting
from the input pose, chi2 5.991 reclassification between rounds, Huber in
the first three rounds. Every product goes through `precision.matmul`, so
the same code is the control one precision lower.
"""

from __future__ import annotations

import math

import torch

from slam_bench.reference.precision import matmul

N_ROUNDS = 4
N_ITERS = 10
TAU = 1e-5
CHI2_MONO = 5.991
HUBER_DELTA2 = 5.991
HUBER_DELTA = math.sqrt(HUBER_DELTA2)
SMALL_THETA2 = 2.5e-3


def _hat(w):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1), torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def exp_se3(xi, mode):
    """[..., 6] tangent (omega, upsilon) -> [..., 4, 4]."""
    w, v = xi[..., :3], xi[..., 3:]
    t2 = torch.sum(w * w, dim=-1)
    small = t2 < SMALL_THETA2
    th = torch.where(small, torch.ones_like(t2), torch.sqrt(t2))
    A = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0, (1.0 - torch.cos(th)) / t2)
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0, (1.0 - A) / t2)
    W = _hat(w)
    W2 = matmul(W, W, mode)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    t = matmul(V, v[..., None], mode)
    bottom = torch.eye(4, dtype=xi.dtype, device=xi.device)[3:].expand(*R.shape[:-2], 1, 4)
    return torch.cat([torch.cat([R, t], -1), bottom], -2)


def orthonormalize(T, mode):
    R = T[..., :3, :3]
    for _ in range(2):
        R = 1.5 * R - 0.5 * matmul(matmul(R, R.transpose(-1, -2), mode), R, mode)
    out = T.clone()
    out[..., :3, :3] = R
    return out


def _huber_weight(e2, use_huber):
    if not use_huber:
        return torch.ones_like(e2)
    return torch.where(e2 <= HUBER_DELTA2, 1.0, HUBER_DELTA / torch.sqrt(torch.clamp(e2, min=1e-12)))


def _huber_rho(e2, use_huber):
    if not use_huber:
        return e2
    rob = 2.0 * HUBER_DELTA * torch.sqrt(torch.clamp(e2, min=1e-12)) - HUBER_DELTA2
    return torch.where(e2 <= HUBER_DELTA2, e2, rob)


def _edge_terms(T, Xw, uv, K, mask, info, use_huber, mode):
    """Residuals [B,E,2], chi2 [B,E], IRLS weights [B,E], J [B,E,2,6]."""
    Xc = matmul(Xw, T[:, :3, :3].transpose(1, 2), mode) + T[:, None, :3, 3]
    fx, fy = K[:, 0, 0, None], K[:, 1, 1, None]
    cx, cy = K[:, 0, 2, None], K[:, 1, 2, None]
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zs = torch.where(z == 0, torch.ones_like(z), z)
    pred = torch.stack([fx * x / zs + cx, fy * y / zs + cy], dim=-1)
    r = pred - uv
    e2 = torch.sum(r * r, dim=-1) * info
    w = _huber_weight(e2, use_huber) * info * mask
    iz = 1.0 / zs
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    Jp = torch.stack([torch.stack([fx * iz, zero, -fx * x * iz * iz], -1),
                      torch.stack([zero, fy * iz, -fy * y * iz * iz], -1)], -2)
    Jx = torch.stack([torch.stack([zero, z, -y, one, zero, zero], -1),
                      torch.stack([-z, zero, x, zero, one, zero], -1),
                      torch.stack([y, -x, zero, zero, zero, one], -1)], -2)
    return r, e2, w, matmul(Jp, Jx, mode)


def _normal_eqs(J, w, r, mode):
    b_, e_ = J.shape[:2]
    wJ = (J * w[..., None, None]).reshape(b_, 2 * e_, 6)
    Jf = J.reshape(b_, 2 * e_, 6)
    return (matmul(wJ.transpose(1, 2), Jf, mode),
            matmul(wJ.transpose(1, 2), r.reshape(b_, 2 * e_, 1), mode)[..., 0])


def _round(T_init, Xw, uv, K, mask, info, use_huber, mode):
    def chi2_from(e2):
        return torch.sum(_huber_rho(e2, use_huber) * mask, dim=-1)

    r, e2, w, J = _edge_terms(T_init, Xw, uv, K, mask, info, use_huber, mode)
    H, b = _normal_eqs(J, w, r, mode)
    lam = TAU * torch.diagonal(H, dim1=-2, dim2=-1).amax(-1)
    nu = torch.full_like(lam, 2.0)
    chi = chi2_from(e2)
    T = T_init
    eye = torch.eye(6, dtype=T.dtype, device=T.device)
    for _ in range(N_ITERS):
        delta = -torch.linalg.solve_ex(H + lam[:, None, None] * eye, b)[0]
        T_new = matmul(exp_se3(delta, mode), T, mode)
        r_n, e2_n, w_n, J_n = _edge_terms(T_new, Xw, uv, K, mask, info, use_huber, mode)
        chi_new = chi2_from(e2_n)
        denom = torch.clamp(torch.sum(delta * (lam[:, None] * delta - b), -1), min=1e-12)
        rho = (chi - chi_new) / denom
        accept = torch.isfinite(chi_new) & (chi_new < chi)
        shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam = torch.where(accept, lam * shrink, lam * nu)
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        a = accept[:, None]
        T = torch.where(a[..., None], T_new, T)
        chi = torch.where(accept, chi_new, chi)
        e2 = torch.where(a, e2_n, e2)
        H_n, b_n = _normal_eqs(J_n, w_n, r_n, mode)
        H = torch.where(a[..., None], H_n, H)
        b = torch.where(a, b_n, b)
    return T, e2


def pose_lm(T_init, Xw, uv, valid, K, info=None, mode: str = "f32"):
    """T_init [B,4,4], Xw [B,E,3], uv [B,E,2], valid bool [B,E], K [B,3,3],
    info [B,E] or None -> (T [B,4,4] orthonormalized, inlier bool [B,E],
    n_good int [B]), in f32 with products in `mode`."""
    f32 = torch.float32
    T_init, Xw, uv, K = (t.to(f32) for t in (T_init, Xw, uv, K))
    info = torch.ones(Xw.shape[:2], dtype=f32, device=Xw.device) if info is None else info.to(f32)
    inlier = torch.ones_like(valid)
    T_fin = T_init
    for it in range(N_ROUNDS):
        mask = (valid & inlier).to(f32)
        T_fin, e2 = _round(T_init, Xw, uv, K, mask, info, it < 3, mode)
        inlier = e2 <= CHI2_MONO
    inlier = inlier & valid
    return orthonormalize(T_fin, mode), inlier, inlier.sum(-1)
