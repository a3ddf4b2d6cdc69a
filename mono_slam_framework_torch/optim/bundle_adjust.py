"""Sparse bundle adjustment with Schur-complement elimination.

PyTorch counterpart of `mono_slam_framework_tpu/optim/bundle_adjust.py`
(the reference's g2o back-end):
  * Optimizer::BundleAdjustment / GlobalBundleAdjustemnt
    (slam_pipeline/src/Optimizer.cc:62-215): all KFs + marginalized
    landmarks, Huber(sqrt(5.99)) when robust, the origin camera fixed;
  * Optimizer::LocalBundleAdjustment (Optimizer.cc:336-574): covisible
    window + fixed cameras, 5 robust LM iterations, prune chi2 > 5.991 /
    negative depth, then 10 plain iterations, then report bad observations.

The edge list is a struct-of-arrays; per-edge 2x6 / 2x3 Jacobian blocks are
built in one vectorized pass, Hessian blocks are `index_add_` scatters (U
per camera, V per landmark, W per edge). The dense solver assembles the
reduced camera system S = U - W V^-1 W^T from per-(edge, edge)-pair 6x6
contributions (pairs sharing a landmark, listed on the host) and solves it
with Jacobi equilibration; the PCG solver applies S matrix-free. The LM
loop uses the Nielsen policy of `optim/lm.py`; rejected steps roll back by
`torch.where`, so an iteration never waits on the device.

BA has no Pallas kernel in the JAX package; this is plain PyTorch on the
device of the problem's tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mono_slam_framework_torch.geometry import se3
from mono_slam_framework_torch.optim import lm


class BAProblem(NamedTuple):
    cam_T: torch.Tensor  # f32 [C,4,4] world->camera
    cam_fixed: torch.Tensor  # bool [C]
    points: torch.Tensor  # f32 [P,3]
    e_cam: torch.Tensor  # int64 [E]
    e_pt: torch.Tensor  # int64 [E]
    e_uv: torch.Tensor  # f32 [E,2]
    e_valid: torch.Tensor  # bool [E]
    e_info: torch.Tensor  # f32 [E] per-edge information (InvSigma2; 1 = identity)
    pair_i: torch.Tensor  # int64 [PAIRS] edge index
    pair_j: torch.Tensor  # int64 [PAIRS] edge index (same landmark as pair_i)
    pair_valid: torch.Tensor  # bool [PAIRS]
    K: torch.Tensor  # f32 [3,3]


def edge_pairs(e_pt: np.ndarray):
    """Ordered pairs of edges sharing a landmark, self-pairs included,
    grouped by landmark in ascending id (the dense Schur assembly's list)."""
    e_pt = np.asarray(e_pt, np.int64)
    order = np.argsort(e_pt, kind="stable")
    pts, starts, counts = np.unique(e_pt[order], return_index=True, return_counts=True)
    pi, pj = [], []
    for s, c in zip(starts, counts):
        es = order[s : s + c]
        pi.append(np.repeat(es, c))
        pj.append(np.tile(es, c))
    if not pi:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(pi), np.concatenate(pj)


def build_problem(
    cam_T, cam_fixed, points, e_cam, e_pt, e_uv, K,
    e_info=None, with_pairs: bool = True, device="cuda",
) -> BAProblem:
    """Host-side problem assembly, including the edge-pair list, onto
    `device`. No padding: shapes are the problem's own.

    `with_pairs=False` skips the O(sum deg^2) edge-pair list, which only the
    dense Schur path reads (the PCG path never touches it)."""
    e_cam = np.asarray(e_cam, np.int64)
    e_pt = np.asarray(e_pt, np.int64)
    E = e_cam.shape[0]
    if e_info is None:
        e_info = np.ones(E, np.float32)
    pi, pj = edge_pairs(e_pt) if with_pairs else (np.zeros(0, np.int64),) * 2

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return BAProblem(
        cam_T=t(cam_T, np.float32),
        cam_fixed=t(cam_fixed, np.bool_),
        points=t(points, np.float32),
        e_cam=t(e_cam, np.int64),
        e_pt=t(e_pt, np.int64),
        e_uv=t(e_uv, np.float32),
        e_valid=t(np.ones(E, bool), np.bool_),
        e_info=t(e_info, np.float32),
        pair_i=t(pi, np.int64),
        pair_j=t(pj, np.int64),
        pair_valid=t(np.ones(len(pi), bool), np.bool_),
        K=t(K, np.float32),
    )


def _inv3x3(M):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), (b * f - c * e)], dim=-1),
            torch.stack([B, (a * i - c * g), -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), (a * e - b * d)], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def _segment_sum(x, idx, n):
    """Sum rows of x [E, ...] into n segments by idx [E]."""
    return torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device).index_add_(
        0, idx, x
    )


def _edge_terms(cam_T, X, p: BAProblem, mask, use_huber: bool):
    """Per-edge residuals, IRLS weights and Jacobians. mask: f32 [E].

    e2 is the information-weighted chi2 (g2o edge->chi2() with Omega =
    e_info * I2); the IRLS weight folds e_info in so the normal equations
    match g2o's per-octave information matrices.
    """
    Te = cam_T[p.e_cam]  # [E,4,4]
    Xe = X[p.e_pt]  # [E,3]
    Xc = torch.einsum("eij,ej->ei", Te[:, :3, :3], Xe) + Te[:, :3, 3]
    fx, fy = p.K[0, 0], p.K[1, 1]
    cx, cy = p.K[0, 2], p.K[1, 2]
    z = Xc[:, 2]
    zs = torch.where(z == 0, torch.ones_like(z), z)
    pred = torch.stack([fx * Xc[:, 0] / zs + cx, fy * Xc[:, 1] / zs + cy], dim=-1)
    r = pred - p.e_uv
    info = p.e_info.to(r.dtype)
    e2 = torch.sum(r * r, dim=-1) * info
    w = lm.huber_weight(e2, use_huber) * info * mask
    Jproj = lm.projection_jacobians(Xc, fx, fy)  # [E,2,3]
    Jc = Jproj @ lm.se3_point_jacobian(Xc)  # [E,2,6]
    Jp = Jproj @ Te[:, :3, :3]  # [E,2,3]
    return r, e2, w, Jc, Jp, z


def _pcg_schur(matvec, prec, rhs, n_iters):
    """Preconditioned CG on the reduced camera system with a fixed iteration
    count (LM tolerates the inexact-Newton step)."""
    tiny = 1e-20
    x = torch.zeros_like(rhs)
    r = rhs
    z = prec(r)
    pdir = z
    rz = torch.sum(r * z)
    for _ in range(n_iters):
        Ap = matvec(pdir)
        denom = torch.sum(pdir * Ap)
        alpha = torch.where(torch.abs(denom) > tiny, rz / denom, torch.zeros_like(rz))
        x = x + alpha * pdir
        r = r - alpha * Ap
        z = prec(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(torch.abs(rz) > tiny, rz_new / rz, torch.zeros_like(rz))
        pdir = z + beta * pdir
        rz = rz_new
    return x


def _lm_iterations(
    cam_T, X, p: BAProblem, edge_mask, use_huber: bool, n_iters: int,
    solver: str = "dense", cg_iters: int = 60,
):
    """Run `n_iters` LM iterations on the masked problem.

    solver="dense": materialize the Schur complement S from the edge-pair
    list and solve it directly — exact, right for local windows.
    solver="cg": matrix-free preconditioned CG on S (each application is
    O(E) scatters; block-Jacobi preconditioner from the self-pair Schur
    diagonal) — no pair list, no [6C,6C] system; the global-BA path for
    hundreds of keyframes.
    """
    dtype = cam_T.dtype
    dev = cam_T.device
    C = cam_T.shape[0]
    P = X.shape[0]
    free = (~p.cam_fixed).to(dtype)  # [C]
    I6 = torch.eye(6, dtype=dtype, device=dev)
    I3 = torch.eye(3, dtype=dtype, device=dev)

    def chi2_of(T, Xp):
        _, e2, _, _, _, _ = _edge_terms(T, Xp, p, edge_mask, use_huber)
        return torch.sum(lm.huber_rho(e2, use_huber) * edge_mask)

    def hessian_diag_max(T, Xp):
        _, _, w, Jc, Jp, _ = _edge_terms(T, Xp, p, edge_mask, use_huber)
        du = torch.sum(Jc * Jc, dim=1) * w[:, None]  # [E,6] diag contributions
        dv = torch.sum(Jp * Jp, dim=1) * w[:, None]
        return torch.maximum(
            torch.max(_segment_sum(du, p.e_cam, C)), torch.max(_segment_sum(dv, p.e_pt, P))
        )

    lam = lm.TAU * hessian_diag_max(cam_T, X)
    chi = chi2_of(cam_T, X)
    nu = torch.full_like(chi, 2.0)
    T, Xp = cam_T, X
    for _ in range(n_iters):
        r, e2, w, Jc, Jp, _ = _edge_terms(T, Xp, p, edge_mask, use_huber)
        # the IRLS weight folded into one side: J^T W J as two-operand products
        wJc = Jc * w[:, None, None]
        wJp = Jp * w[:, None, None]
        U = _segment_sum(wJc.transpose(1, 2) @ Jc, p.e_cam, C)  # [C,6,6]
        V = _segment_sum(wJp.transpose(1, 2) @ Jp, p.e_pt, P)  # [P,3,3]
        W = wJc.transpose(1, 2) @ Jp  # [E,6,3] (edge-local)
        bc = _segment_sum((wJc.transpose(1, 2) @ r[..., None])[..., 0], p.e_cam, C)
        bp = _segment_sum((wJp.transpose(1, 2) @ r[..., None])[..., 0], p.e_pt, P)

        U = U + lam * I6
        Vinv = _inv3x3(V + lam * I3)
        Y = W @ Vinv[p.e_pt]  # [E,6,3]

        # reduced rhs = -(bc - sum_e Y_e bp[pt_e]) per camera
        ybp = (Y @ bp[p.e_pt][..., None])[..., 0]
        red = bc - _segment_sum(ybp, p.e_cam, C)  # [C,6]

        if solver == "dense":
            # Schur assembly: S[ci,cj] -= sum over pairs Y_i W_j^T
            contrib = Y[p.pair_i] @ W[p.pair_j].transpose(-1, -2)
            contrib = contrib * p.pair_valid.to(dtype)[:, None, None]
            ci = p.e_cam[p.pair_i]
            cj = p.e_cam[p.pair_j]
            S = -_segment_sum(contrib, ci * C + cj, C * C).reshape(C, C, 6, 6)
            S[torch.arange(C, device=dev), torch.arange(C, device=dev)] += U
            S = S.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
            rhs = -red.reshape(6 * C)

            # fixed cameras: identity rows/cols, zero rhs
            fmask = torch.repeat_interleave(free, 6)  # [6C]
            S = S * fmask[:, None] * fmask[None, :] + torch.diag(1.0 - fmask)
            rhs = rhs * fmask

            # Jacobi equilibration for f32 conditioning
            d = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(S)), min=1e-12))
            dinv = 1.0 / d
            Ss = S * dinv[:, None] * dinv[None, :]
            ys = torch.linalg.solve_ex(Ss, rhs * dinv)[0]
            dc = (ys * dinv).reshape(C, 6) * free[:, None]
        else:  # matrix-free PCG on the Schur complement
            rhs_c = -red * free[:, None]  # [C,6]; fixed rows pinned to 0

            def matvec(x, U=U, W=W, Vinv=Vinv):
                # S x = U x - W V^-1 W^T x; fixed-camera rows act as identity
                ux = (U @ x[..., None])[..., 0]
                wx = (W.transpose(-1, -2) @ x[p.e_cam][..., None])[..., 0]  # [E,3]
                vp = (Vinv @ _segment_sum(wx, p.e_pt, P)[..., None])[..., 0]
                back = (W @ vp[p.e_pt][..., None])[..., 0]  # [E,6]
                out = ux - _segment_sum(back, p.e_cam, C)
                return out * free[:, None] + x * (1.0 - free)[:, None]

            # block-Jacobi preconditioner from the self-pair Schur diagonal
            # S_cc ~ U_c - sum_{e in c} Y_e W_e^T
            diag_sub = _segment_sum(Y @ W.transpose(-1, -2), p.e_cam, C)
            Sd = U - diag_sub + 1e-6 * I6
            Sd = torch.where(p.cam_fixed[:, None, None], I6, Sd)
            Sd_inv = torch.linalg.inv_ex(Sd)[0]

            def prec(x, Sd_inv=Sd_inv):
                return (Sd_inv @ x[..., None])[..., 0] * free[:, None]

            dc = _pcg_schur(matvec, prec, rhs_c, cg_iters) * free[:, None]

        # landmark back-substitution: dp = -Vinv (bp + W^T dc)
        wt_dc = (W.transpose(-1, -2) @ dc[p.e_cam][..., None])[..., 0]  # [E,3]
        dp = -(Vinv @ (bp + _segment_sum(wt_dc, p.e_pt, P))[..., None])[..., 0]

        T_new = se3.exp_se3(dc) @ T
        X_new = Xp + dp
        chi_new = chi2_of(T_new, X_new)

        pred_dec = torch.sum(dc * (lam * dc - bc)) + torch.sum(dp * (lam * dp - bp))
        rho = (chi - chi_new) / torch.clamp(pred_dec, min=1e-12)
        accept = torch.isfinite(chi_new) & (chi_new < chi)
        lam, nu = lm.nielsen_update(lam, nu, rho, accept)
        T = torch.where(accept, T_new, T)
        Xp = torch.where(accept, X_new, Xp)
        chi = torch.where(accept, chi_new, chi)
    # keep FREE camera estimates exactly on SE(3), like g2o's SE3Quat
    # vertices; fixed cameras pass through bit-exact
    T = torch.where(p.cam_fixed[:, None, None], T, se3.orthonormalize(T))
    return T, Xp, chi


def bundle_adjust(p: BAProblem, n_iters: int = 20, robust: bool = True):
    """Plain BA (Optimizer::BundleAdjustment): no pruning between iterations.

    Returns (cam_T, points, chi2).
    """
    mask = p.e_valid.to(p.cam_T.dtype)
    return _lm_iterations(p.cam_T, p.points, p, mask, robust, n_iters)


def global_bundle_adjust(
    p: BAProblem, n_iters: int = 20, robust: bool = True, cg_iters: int = 60
):
    """Scalable full-map BA: matrix-free PCG on the Schur complement.

    Same LM schedule as `bundle_adjust`, but it never materializes the
    [6C,6C] reduced system and needs no edge-pair list (build the problem
    with `with_pairs=False`).
    """
    mask = p.e_valid.to(p.cam_T.dtype)
    return _lm_iterations(
        p.cam_T, p.points, p, mask, robust, n_iters, solver="cg", cg_iters=cg_iters
    )


def local_bundle_adjust(p: BAProblem):
    """Local BA schedule (Optimizer::LocalBundleAdjustment, 497-549):

    5 robust iterations -> drop edges with chi2 > 5.991 or non-positive depth
    -> 10 plain iterations -> final bad-edge classification.

    Returns (cam_T, points, bad_edge bool [E], chi2).
    """
    dtype = p.cam_T.dtype
    mask0 = p.e_valid.to(dtype)
    T1, X1, _ = _lm_iterations(p.cam_T, p.points, p, mask0, True, 5)
    _, e2, _, _, _, z = _edge_terms(T1, X1, p, mask0, False)
    keep = p.e_valid & (e2 <= lm.CHI2_MONO) & (z > 0)
    T2, X2, chi = _lm_iterations(T1, X1, p, keep.to(dtype), False, 10)
    _, e2f, _, _, _, zf = _edge_terms(T2, X2, p, mask0, False)
    bad = p.e_valid & ((e2f > lm.CHI2_MONO) | (zf <= 0))
    return T2, X2, bad, chi
