"""Batched EPnP + RANSAC for relocalization.

PyTorch counterpart of `mono_slam_framework_tpu/estimation/epnp.py`, the
capability twin of the reference PnPsolver (slam_pipeline/include/PnPsolver.h,
src/PnPsolver.cc): the EPnP (Lepetit et al.) minimal solver inside an
adaptive RANSAC loop with the reference parameters (probability 0.99,
minInliers 10, maxIterations 300, minSet 4, epsilon 0.5, th2 5.991 —
Tracking.cc:776), the reference's iteration-count formula with its
hardcoded epsilon^3 exponent (PnPsolver.cc:158-159), and refine-on-all-
inliers with the strict '>' accept (PnPsolver.cc:288).

Every RANSAC hypothesis runs at once: the solver functions take a leading
hypothesis axis (the JAX package vmaps them), so minimal-set selection, the
12x12 eigendecompositions, the beta cases with Gauss-Newton, Horn alignment
and inlier counting are one batch of device ops. Reference quirk B2 (the
rep_errors[N] out-of-bounds case-selection typo) is fixed as in the JAX
package: the best beta case is chosen by its actual reprojection error.

The minimal sets are drawn on the caller's host `torch.Generator`
(`draw_minimal_sets`, uniforms then top-k as the JAX package draws with its
key) and moved to the device, so one seed draws the same sets on the CPU and
on the card. Problems go in at their own size: the JAX package's pow2
point-capacity padding and its compile prewarming are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

# the six control-point pairs (a, b), a < b
_PAIR_A = (0, 0, 0, 1, 1, 2)
_PAIR_B = (1, 2, 3, 2, 3, 3)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _control_points(X, w):
    """Weighted centroid + PCA control points. X [B,n,3], w [B,n] -> [B,4,3]."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    c0 = (X * w[..., None]).sum(-2) / wsum
    Xc = (X - c0[..., None, :]) * w[..., None]
    cov = Xc.transpose(-1, -2) @ Xc / wsum[..., None]
    eval_, evec = torch.linalg.eigh(cov)  # ascending
    # axes scaled by sqrt(eigenvalue); the tiny floor keeps degenerate
    # (planar) sets solvable
    scales = torch.sqrt(torch.clamp(eval_, min=1e-10))
    axes = evec.transpose(-1, -2) * scales[..., :, None]  # [B,3,3] rows
    return torch.cat([c0[..., None, :], c0[..., None, :] + axes], dim=-2)


def _barycentric(X, C):
    """alphas with X = sum_j alpha_j C_j, sum alpha = 1. X [B,n,3] -> [B,n,4]."""
    Bm = (C[..., 1:, :] - C[..., :1, :]).transpose(-1, -2)  # [B,3,3]
    Binv = torch.linalg.inv(Bm + 1e-12 * _eye(3, X))
    a123 = (X - C[..., :1, :]) @ Binv.transpose(-1, -2)
    a0 = 1.0 - a123.sum(-1, keepdim=True)
    return torch.cat([a0, a123], dim=-1)


def _build_M(alphas, uv, K, w):
    """EPnP M matrix rows, weighted. -> [B, 2n, 12]."""
    fu, fv = K[0, 0], K[1, 1]
    uc, vc = K[0, 2], K[1, 2]
    shape = alphas.shape[:-1] + (12,)
    a = alphas * w[..., None]
    zero = torch.zeros_like(a)
    du = (uc - uv[..., 0])[..., None] * alphas * w[..., None]
    dv = (vc - uv[..., 1])[..., None] * alphas * w[..., None]
    # row u: [a_j fu, 0, a_j (uc - u)] per control point j
    ru = torch.stack([a * fu, zero, du], dim=-1).reshape(shape)
    rv = torch.stack([zero, a * fv, dv], dim=-1).reshape(shape)
    return torch.cat([ru, rv], dim=-2)


def _dv_pairs(V):
    """Differences of candidate control-point solutions over the 6 pairs.

    V: [B,4,12] four smallest eigenvectors, each 4 control points x 3.
    Returns dv [B,6,4,3]: pair k, basis i.
    """
    Vr = V.reshape(V.shape[:-1] + (4, 3))  # [B, basis, ctrl, xyz]
    dv = Vr[..., _PAIR_A, :] - Vr[..., _PAIR_B, :]  # [B, basis, pair, xyz]
    return dv.transpose(-3, -2)


def _rho(Cw):
    """Squared distances of the 6 control-point pairs. [B,4,3] -> [B,6]."""
    d = Cw[..., _PAIR_A, :] - Cw[..., _PAIR_B, :]
    return (d * d).sum(-1)


def _gauss_newton(betas, dv, rho, iters: int = 6):
    """Refine betas so control-point distances match rho (PnPsolver GN)."""
    reg = 1e-9 * _eye(4, betas)
    dvt = dv.transpose(-1, -2)  # [B,6,3,4]
    b = betas
    for _ in range(iters):
        e = (dvt @ b[..., None, :, None])[..., 0]  # [B,6,3]
        r = (e * e).sum(-1) - rho  # [B,6]
        J = 2.0 * (dv @ e[..., None])[..., 0]  # [B,6,4]
        Jt = J.transpose(-1, -2)
        delta = -torch.linalg.solve(Jt @ J + reg, (Jt @ r[..., None])[..., 0])
        b = b + delta
    return b


def _betas_seed(dv, rho, case: int):
    """Least-squares seeds mirroring find_betas_approx_{1,2,3}."""
    # products of betas appearing linearly: case1 -> b11; case2 -> b11,b12,b22;
    # case3 -> b11,b12,b22,b13,b23
    g = dv @ dv.transpose(-1, -2)  # [B,6,4,4] gram per pair

    def lsq(cols):
        A = torch.stack(cols, dim=-1)  # [B,6,m]
        At = A.transpose(-1, -2)
        AtA = At @ A + 1e-9 * _eye(A.shape[-1], A)
        return torch.linalg.solve(AtA, (At @ rho[..., None])[..., 0])

    if case == 1:
        x = lsq([g[..., 0, 0]])
        b1 = torch.sqrt(torch.abs(x[..., 0]))
        z = 0.0 * b1
        return torch.stack([b1, z, z, z], dim=-1)
    if case == 2:
        x = lsq([g[..., 0, 0], 2 * g[..., 0, 1], g[..., 1, 1]])
        b1 = torch.sqrt(torch.abs(x[..., 0]))
        b2 = torch.sqrt(torch.abs(x[..., 2])) * torch.sign(x[..., 1]) * torch.sign(x[..., 0])
        z = 0.0 * b1
        return torch.stack([b1, b2, z, z], dim=-1)
    x = lsq([g[..., 0, 0], 2 * g[..., 0, 1], g[..., 1, 1], 2 * g[..., 0, 2],
             2 * g[..., 1, 2]])
    b1 = torch.sqrt(torch.abs(x[..., 0]))
    b2 = torch.sqrt(torch.abs(x[..., 2])) * torch.sign(x[..., 1]) * torch.sign(x[..., 0])
    b3 = x[..., 3] / torch.where(b1 == 0, 1e-9, b1)
    z = 0.0 * b1
    return torch.stack([b1, b2, b3, z], dim=-1)


def _horn(pw, pc, w):
    """Absolute orientation: R [B,3,3], t [B,3] with pc ~ R pw + t (weighted)."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    cw = (pw * w[..., None]).sum(-2) / wsum
    cc = (pc * w[..., None]).sum(-2) / wsum
    H = ((pw - cw[..., None, :]) * w[..., None]).transpose(-1, -2) @ (pc - cc[..., None, :])
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.linalg.det(V @ Ut)
    one = 1.0 + 0.0 * d
    # the reflection fix: det(V U^T) = -1 flips the last axis
    R = V @ torch.diag_embed(torch.stack([one, one, d], dim=-1)) @ Ut
    t = cc - (R @ cw[..., None])[..., 0]
    return R, t


def _project_err2(R, t, X, uv, K):
    """Squared reprojection error of X [..,n,3] under (R, t); a zero depth
    divides by 1e-9, as the JAX package does (kept a torch.where: no host
    branch)."""
    Xc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.where(Xc[..., 2] == 0, 1e-9, Xc[..., 2])
    u = K[0, 0] * Xc[..., 0] / z + K[0, 2]
    v = K[1, 1] * Xc[..., 1] / z + K[1, 2]
    return (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2


def _epnp_basis(X, uv, K, w):
    """The EPnP linear system's pieces: control points Cw [B,4,3], the
    barycentric alphas [B,n,4] and the four eigenvectors of M^T M with the
    smallest eigenvalues, V [B,4,12]. A minimal set of 4 leaves M^T M a
    4-dimensional null space, whose basis each eigensolver picks its own way;
    the pose that `_epnp_solve` builds on it depends on that choice."""
    Cw = _control_points(X, w)
    alphas = _barycentric(X, Cw)
    M = _build_M(alphas, uv, K, w)
    _, evec = torch.linalg.eigh(M.transpose(-1, -2) @ M)  # ascending eigenvalues
    return Cw, alphas, evec[..., :, :4].transpose(-1, -2)


def _epnp_solve(X, uv, K, w, Cw, alphas, V):
    """The three beta cases with Gauss-Newton on the basis V, each case's
    pose by Horn alignment, the case with the least reprojection error kept
    (the quirk-B2 fix). Returns (R [B,3,3], t [B,3], err2_mean [B])."""
    dv = _dv_pairs(V)
    rho = _rho(Cw)
    wsum = torch.clamp(w.sum(-1), min=1e-9)

    def pose_from_betas(betas):
        # camera-frame control points, then world points via alphas
        Cc = (betas[..., None, :] @ V)[..., 0, :].reshape(betas.shape[:-1] + (4, 3))
        pc = alphas @ Cc  # [B,n,3]
        # resolve the global sign so depths are positive
        sign = 1.0 - 2.0 * ((pc[..., 2] * w).sum(-1) < 0).to(pc.dtype)
        R, t = _horn(X, pc * sign[..., None, None], w)
        err2 = _project_err2(R, t, X, uv, K)
        return R, t, (err2 * w).sum(-1) / wsum

    lead = X.shape[:-2]
    best_R = _eye(3, X).expand(lead + (3, 3))
    best_t = X.new_zeros(lead + (3,))
    best_err = torch.full(lead, torch.inf, dtype=X.dtype, device=X.device)
    for case in (1, 2, 3):
        betas = _gauss_newton(_betas_seed(dv, rho, case), dv, rho)
        R, t, err = pose_from_betas(betas)
        better = err < best_err
        best_R = torch.where(better[..., None, None], R, best_R)
        best_t = torch.where(better[..., None], t, best_t)
        best_err = torch.where(better, err, best_err)
    return best_R, best_t, best_err


def _epnp_pose(X, uv, K, w):
    """One EPnP solve per hypothesis on weighted correspondences X [B,n,3],
    uv [B,n,2], w [B,n]. Returns (R [B,3,3], t [B,3], err2_mean [B])."""
    return _epnp_solve(X, uv, K, w, *_epnp_basis(X, uv, K, w))


def _count_inliers(R, t, X, uv, K, valid, th2):
    """Inliers of each pose (R [B,3,3], t [B,3]) over all N correspondences
    X [N,3], uv [N,2]: (mask [B,N], count [B])."""
    err2 = _project_err2(R, t, X, uv, K)
    # strict '<' (PnPsolver.cc:324)
    inl = (err2 < th2) & valid
    return inl, inl.sum(-1)


def draw_minimal_sets(n: int, iterations: int, min_set: int, generator) -> torch.Tensor:
    """[iterations, min_set] distinct indices into n correspondences: a
    uniform key per (hypothesis, point), then the top min_set keys
    (`_ransac_epnp`'s draw in the JAX package). Drawn on the generator's
    device."""
    r = torch.rand((iterations, n), generator=generator, device=generator.device)
    return torch.topk(r, min_set, dim=1).indices


def _ransac_epnp(X, uv, valid, K, sets, th2):
    """All RANSAC hypotheses (one per row of `sets`) at once. Returns the
    best (R, t, inliers, count); ties go to the first hypothesis."""
    Xs, uvs = X[sets], uv[sets]
    w = torch.ones(sets.shape, dtype=X.dtype, device=X.device)
    R, t, _ = _epnp_pose(Xs, uvs, K, w)
    inl, cnt = _count_inliers(R, t, X, uv, K, valid, th2)
    best = torch.argmax(cnt)
    return R[best], t[best], inl[best], cnt[best]


def _refine_epnp(X, uv, K, weights, valid, th2):
    """EPnP on all correspondences weighted by the inlier mask, then its
    inliers (PnPsolver::Refine)."""
    R, t, _ = _epnp_pose(X[None], uv[None], K, weights[None])
    inl, cnt = _count_inliers(R, t, X, uv, K, valid, th2)
    return R[0], t[0], inl[0], cnt[0]


def ransac_iterations(n: int, probability: float = 0.99, min_inliers: int = 10,
                      max_iterations: int = 300, min_set: int = 4,
                      epsilon: float = 0.5):
    """The adaptive RANSAC parameters of PnPsolver::SetRansacParameters
    (PnPsolver.cc:143-161) for n correspondences: (n_min_inliers,
    hypotheses), hypotheses None when the problem is unsolvable. The count is
    rounded up to a power of two and clamped to the power of two at or below
    max_iterations, as the JAX package does (epnp.py:282-290): it sets the
    number of hypotheses, so it is part of the semantics."""
    if n < min_set:
        return None, None
    n_min_inliers = max(int(n * epsilon), min_inliers, min_set)
    if n < n_min_inliers:
        # fewer correspondences than the required inlier support: eps would
        # exceed 1 and the iteration formula NaNs (log of a negative)
        return n_min_inliers, None
    eps = max(epsilon, n_min_inliers / n)
    if n_min_inliers == n:
        n_iter = 1
    else:
        # the reference hardcodes the epsilon^3 exponent (PnPsolver.cc:159)
        n_iter = int(np.ceil(np.log(1 - probability) / np.log(1 - eps**3)))
    n_iter = max(1, n_iter)
    n_iter = 1 << (n_iter - 1).bit_length()
    if n_iter > max_iterations:
        n_iter = max(1, 1 << (int(max_iterations).bit_length() - 1))
    return n_min_inliers, n_iter


def solve_pnp_ransac(
    X: np.ndarray,
    uv: np.ndarray,
    K: np.ndarray,
    generator: torch.Generator,
    probability: float = 0.99,
    min_inliers: int = 10,
    max_iterations: int = 300,
    min_set: int = 4,
    epsilon: float = 0.5,
    chi2_threshold: float = 5.991,
    device="cuda",
):
    """PnPsolver::SetRansacParameters + iterate + Refine on the host's side.

    Runs on `device`; the minimal sets are drawn from the host `generator`.
    Returns (ok, Tcw [4,4] f32, inlier_mask [N] bool).
    """
    N = len(X)
    n_min_inliers, n_iter = ransac_iterations(
        N, probability, min_inliers, max_iterations, min_set, epsilon
    )
    if n_iter is None:
        return False, None, np.zeros(N, bool)
    sets = draw_minimal_sets(N, n_iter, min_set, generator)
    dev = torch.device(device)
    Xd = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(dev)
    uvd = torch.from_numpy(np.ascontiguousarray(uv, np.float32)).to(dev)
    Kd = torch.from_numpy(np.ascontiguousarray(K, np.float32)).to(dev)
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    R, t, inl, cnt = _ransac_epnp(Xd, uvd, valid, Kd, sets.to(dev), chi2_threshold)
    if int(cnt) < n_min_inliers:
        return False, None, np.zeros(N, bool)

    # refine on all inliers (PnPsolver::Refine, 259-300)
    R2, t2, inl2, cnt2 = _refine_epnp(Xd, uvd, Kd, inl.to(Xd.dtype), valid, chi2_threshold)
    if int(cnt2) > n_min_inliers:  # strict '>' (PnPsolver.cc:288)
        R, t, inl = R2, t2, inl2

    Tcw = np.eye(4, dtype=np.float32)
    Tcw[:3, :3] = R.cpu().numpy()
    Tcw[:3, 3] = t.cpu().numpy()
    return True, Tcw, inl.cpu().numpy()

