"""Motion-only pose optimization (the reference's PoseOptimization).

PyTorch counterpart of `mono_slam_framework_tpu/optim/pose_opt.py`
(Optimizer::PoseOptimization, Optimizer.cc:217-334): one SE3 vertex, unary
projection edges, 4 rounds x 10 LM iterations with chi2 = 5.991 outlier
reclassification between rounds, the Huber kernel dropped for the last
round, and — a reference behavior kept on purpose — every round RESTARTS
from the input pose (Optimizer.cc:295).

`pose_optimize` dispatches on the device of its tensors: CPU tensors run
`pose_optimize_plain` below; CUDA tensors launch the hand-written kernel
(`pose_opt_cuda.pose_optimize_cuda`), which computes the same schedule in
one launch. `pose_lm_batched_plain` is the plain version of the kernel's
batched launcher (`pose_opt_cuda.pose_lm_batched`); `pose_optimize_batched`
picks between the two by device, as `pose_optimize` does (the multi-stream
steady step's two LM phases: one launch each for all N streams).

Each round carries the chi2 of its accepted pose (as the Pallas kernel
carries e2), and the next round's mask is reclassified from it: the chi2
does not depend on the mask or the Huber kernel, so it equals a fresh pass
at the round's pose.
"""

from __future__ import annotations

import torch

from mono_slam_framework_torch.geometry import se3
from mono_slam_framework_torch.optim import lm

N_ROUNDS = 4
N_ITERS = 10


def _edge_terms(T, Xw, uv, K, mask, info, use_huber: bool):
    """Residuals, IRLS weights and per-edge J [E,2,6] at pose T.

    e2 is the information-weighted chi2 (g2o edge->chi2() = r^T Omega r)
    and the IRLS weight folds info in, so H = J^T w J matches g2o.
    """
    Xc = Xw @ T[:3, :3].T + T[:3, 3]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    z = torch.where(Xc[:, 2] == 0, 1.0, Xc[:, 2])
    pred = torch.stack([fx * Xc[:, 0] / z + cx, fy * Xc[:, 1] / z + cy], dim=-1)
    r = pred - uv  # [E,2]
    e2 = torch.sum(r * r, dim=-1) * info
    w = lm.huber_weight(e2, use_huber) * info * mask
    J = lm.projection_jacobians(Xc, fx, fy) @ lm.se3_point_jacobian(Xc)
    return r, e2, w, J


def _normal_eqs(J, w, r):
    # two-operand products: a three-operand einsum searches a contraction
    # path on the host at every call
    wJ = (J * w[:, None, None]).reshape(-1, 6)
    return wJ.T @ J.reshape(-1, 6), wJ.T @ r.reshape(-1)


def _round(T_init, Xw, uv, K, mask, info, use_huber: bool):
    """One reference round: 10 LM iterations from T_init with a fixed mask.

    The edge terms at the current pose are carried across iterations (each
    step evaluates them once, at the trial pose, and keeps them on
    acceptance). Accept/reject is a `torch.where`, so the loop never waits
    on the device. Returns (T, chi2 [E] of every edge at T).
    """

    def chi2_from(e2):
        return torch.sum(lm.huber_rho(e2, use_huber) * mask)

    r, e2, w, J = _edge_terms(T_init, Xw, uv, K, mask, info, use_huber)
    H, b = _normal_eqs(J, w, r)
    lam = lm.TAU * torch.max(torch.diagonal(H))
    nu = torch.full_like(lam, 2.0)
    chi = chi2_from(e2)
    T = T_init
    eye = torch.eye(6, dtype=T.dtype, device=T.device)
    for _ in range(N_ITERS):
        delta = -torch.linalg.solve_ex(H + lam * eye, b)[0]
        T_new = se3.exp_se3(delta) @ T
        r_n, e2_n, w_n, J_n = _edge_terms(T_new, Xw, uv, K, mask, info, use_huber)
        chi_new = chi2_from(e2_n)
        # gain ratio: predicted decrease = delta^T (lambda*delta - b)
        denom = torch.clamp(torch.dot(delta, lam * delta - b), min=1e-12)
        rho = (chi - chi_new) / denom
        accept = torch.isfinite(chi_new) & (chi_new < chi)
        lam, nu = lm.nielsen_update(lam, nu, rho, accept)
        T = torch.where(accept, T_new, T)
        chi = torch.where(accept, chi_new, chi)
        e2 = torch.where(accept, e2_n, e2)
        H_n, b_n = _normal_eqs(J_n, w_n, r_n)
        H = torch.where(accept, H_n, H)
        b = torch.where(accept, b_n, b)
    return T, e2


def pose_optimize_plain(T_init, Xw, uv, valid, K, info=None):
    """The 4x10 schedule in plain PyTorch (any device, f32 or f64).

    Args:
      T_init: [4,4] initial world->camera pose; its dtype sets the math's.
      Xw: [E,3] map-point positions (padded).
      uv: [E,2] observed pixels.
      valid: bool [E] true for real edges.
      K: [3,3] intrinsics.
      info: optional [E] per-edge information weights (InvSigma2).

    Returns:
      (T_opt [4,4], inlier bool [E], n_good int tensor) — n_good mirrors the
      reference's nInitialCorrespondences - nBad (Optimizer.cc:333).
    """
    dtype = T_init.dtype
    Xw = Xw.to(dtype)
    uv = uv.to(dtype)
    K = K.to(dtype)
    info = (
        torch.ones(Xw.shape[0], dtype=dtype, device=Xw.device)
        if info is None
        else info.to(dtype)
    )
    inlier = torch.ones_like(valid)
    T_fin = T_init
    for it in range(N_ROUNDS):
        mask = (valid & inlier).to(dtype)
        T_fin, e2 = _round(T_init, Xw, uv, K, mask, info, use_huber=it < 3)
        # reclassify ALL edges by chi2 at the round's pose (Optimizer.cc:300-321)
        inlier = e2 <= lm.CHI2_MONO
    inlier = inlier & valid
    n_good = torch.sum(inlier.to(torch.int32))
    return se3.orthonormalize(T_fin), inlier, n_good


def pose_lm_batched_plain(T_init, Xw, uv, valid, K, info=None):
    """Plain version of kernel B2's batched launcher over B problems.

    T_init [B,4,4], Xw [B,E,3], uv [B,E,2], valid bool [B,E], K [B,3,3],
    info [B,E] or None. Returns (T [B,4,4] orthonormalized, inlier bool [B,E]
    ANDed with valid, n_good int32 [B]).
    """
    outs = [
        pose_optimize_plain(T_init[i], Xw[i], uv[i], valid[i], K[i],
                            None if info is None else info[i])
        for i in range(Xw.shape[0])
    ]
    T, inlier, n_good = (torch.stack(x) for x in zip(*outs))
    return T, inlier, n_good.to(torch.int32)


def pose_optimize(T_init, Xw, uv, valid, K, info=None):
    """4x10 LM pose refinement with inter-round outlier reclassification.

    CPU tensors run `pose_optimize_plain`; CUDA tensors launch the kernel
    (f32 only — the wrapper raises on anything the kernel does not take).
    Same arguments and returns as `pose_optimize_plain`.
    """
    if T_init.is_cuda:
        from mono_slam_framework_torch.optim import pose_opt_cuda

        return pose_opt_cuda.pose_optimize_cuda(T_init, Xw, uv, valid, K, info)
    return pose_optimize_plain(T_init, Xw, uv, valid, K, info)


def pose_optimize_batched(T_init, Xw, uv, valid, K, info=None):
    """The 4x10 schedule over B problems (leading axis B on every argument):
    `pose_lm_batched_plain` for CPU tensors, one kernel B2 launch
    (`pose_opt_cuda.pose_lm_batched`) for CUDA tensors. Returns (T [B,4,4],
    inlier bool [B,E], n_good int32 [B])."""
    if T_init.is_cuda:
        from mono_slam_framework_torch.optim import pose_opt_cuda

        return pose_opt_cuda.pose_lm_batched(T_init, Xw, uv, valid, K, info)
    return pose_lm_batched_plain(T_init, Xw, uv, valid, K, info)
