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
built in one vectorized pass, Hessian blocks are segment sums (U per
camera, V per landmark, W per edge). Each segment is summed in edge order
(`torch.segment_reduce` over a stable sort of the index), the order the CPU's
`index_add_` adds in: the card gives the CPU's sums, and the same map on
every run, where an atomic `index_add_` adds in arrival order and no two runs
of a System agree. The dense solver assembles the
reduced camera system S = U - W V^-1 W^T from per-(edge, edge)-pair 6x6
contributions (pairs sharing a landmark, listed on the host) and solves it
with Jacobi equilibration; the PCG solver applies S matrix-free. The LM
loop uses the Nielsen policy of `optim/lm.py`; rejected steps roll back by
`torch.where`, so an iteration never waits on the device.

BA has no Pallas kernel in the JAX package; this is plain PyTorch on the
device of the problem's tensors. `_lm_iterations` also runs edge-sharded
over a device mesh (`parallel/ba_sharded.py`).
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


class _Segments(NamedTuple):
    """The rows of an [E, ...] tensor grouped by a segment index [E]."""

    order: torch.Tensor  # int64 [E], the stable sort of the index
    lengths: torch.Tensor  # int64 [n], rows per segment


def _segments(idx, n: int) -> _Segments:
    # integer counts are exact in any order; no host read
    lengths = torch.zeros(n, dtype=torch.int64, device=idx.device).index_add_(
        0, idx, torch.ones_like(idx)
    )
    return _Segments(torch.argsort(idx, stable=True), lengths)


def _segment_sum(x, seg: _Segments):
    """Sum rows of x [E, ...] into the segments, each in edge order."""
    return torch.segment_reduce(x[seg.order], "sum", lengths=seg.lengths, axis=0,
                                unsafe=True)


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


def _edge_shards(p: BAProblem, edge_mask, mesh):
    """The edge arrays of p and the mask cut into the mesh's shards, shard i
    on device i (with K, the one replicated input its edge terms read)."""
    edges = [mesh.split(x) for x in (p.e_cam, p.e_pt, p.e_uv, p.e_valid, p.e_info)]
    shards = [p._replace(e_cam=c, e_pt=q, e_uv=u, e_valid=v, e_info=f, K=k)
              for c, q, u, v, f, k in zip(*edges, mesh.broadcast(p.K))]
    return shards, mesh.split(edge_mask)


def _lm_iterations(
    cam_T, X, p: BAProblem, edge_mask, use_huber: bool, n_iters: int,
    solver: str = "dense", cg_iters: int = 60, mesh=None,
):
    """Run `n_iters` LM iterations on the masked problem.

    solver="dense": materialize the Schur complement S from the edge-pair
    list and solve it directly — exact, right for local windows.
    solver="cg": matrix-free preconditioned CG on S (each application is
    O(E) scatters; block-Jacobi preconditioner from the self-pair Schur
    diagonal) — no pair list, no [6C,6C] system; the global-BA path for
    hundreds of keyframes.

    `mesh` (a `parallel.mesh.Mesh`, cg only) is the port's form of the JAX
    `reduce=` hook: the edges are cut into the mesh's shards and every piece
    of edge work (edge terms, segment sums, the PCG matvec's scatters) runs
    per shard on its device; each edge->global sum is `mesh.reduce_sum` of
    the shards' partials on the mesh's first device, where the replicated
    camera and point math (the [C,6,6] / [P,3,3] blocks, the PCG scalars,
    the LM accept test) runs once and is copied to the shards. Without a
    mesh the one shard is p itself and a reduction is its one partial, so
    the single-device path runs exactly the operations it always ran.
    """
    dtype = cam_T.dtype
    dev = cam_T.device
    C = cam_T.shape[0]
    P = X.shape[0]
    free = (~p.cam_fixed).to(dtype)  # [C]
    if mesh is None:
        shards, masks = [p], [edge_mask]
        reduce, bcast = (lambda parts: parts[0]), (lambda x: [x])
    else:
        if solver != "cg":
            raise ValueError("the edge-sharded BA runs the cg solver only")
        shards, masks = _edge_shards(p, edge_mask, mesh)
        reduce, bcast = mesh.reduce_sum, mesh.broadcast
    by_cam = [_segments(s.e_cam, C) for s in shards]
    by_pt = [_segments(s.e_pt, P) for s in shards]
    if solver == "dense":  # the Schur blocks S[ci, cj] by camera pair
        by_pair = _segments(p.e_cam[p.pair_i] * C + p.e_cam[p.pair_j], C * C)
    I6 = torch.eye(6, dtype=dtype, device=dev)
    I3 = torch.eye(3, dtype=dtype, device=dev)

    def terms(T, Xp):
        """_edge_terms of every shard at the replicated state (T, Xp)."""
        return [_edge_terms(t, x, s, m, use_huber)
                for t, x, s, m in zip(bcast(T), bcast(Xp), shards, masks)]

    def seg_sum(parts, segs):
        """Each shard's partial segment sums, reduced onto the first device."""
        return reduce([_segment_sum(x, g) for x, g in zip(parts, segs)])

    def chi2_of(T, Xp):
        return reduce([torch.sum(lm.huber_rho(t[1], use_huber) * m)
                       for t, m in zip(terms(T, Xp), masks)])

    def hessian_diag_max(T, Xp):
        tt = terms(T, Xp)
        du = [torch.sum(Jc * Jc, dim=1) * w[:, None] for _, _, w, Jc, _, _ in tt]  # [E,6]
        dv = [torch.sum(Jp * Jp, dim=1) * w[:, None] for _, _, w, _, Jp, _ in tt]
        return torch.maximum(torch.max(seg_sum(du, by_cam)), torch.max(seg_sum(dv, by_pt)))

    lam = lm.TAU * hessian_diag_max(cam_T, X)
    chi = chi2_of(cam_T, X)
    nu = torch.full_like(chi, 2.0)
    T, Xp = cam_T, X
    for _ in range(n_iters):
        tt = terms(T, Xp)
        # the IRLS weight folded into one side: J^T W J as two-operand products
        wJc = [Jc * w[:, None, None] for _, _, w, Jc, _, _ in tt]
        wJp = [Jp * w[:, None, None] for _, _, w, _, Jp, _ in tt]
        U = seg_sum([a.transpose(1, 2) @ t[3] for a, t in zip(wJc, tt)], by_cam)  # [C,6,6]
        V = seg_sum([a.transpose(1, 2) @ t[4] for a, t in zip(wJp, tt)], by_pt)  # [P,3,3]
        W = [a.transpose(1, 2) @ t[4] for a, t in zip(wJc, tt)]  # [E,6,3] (edge-local)
        bc = seg_sum([(a.transpose(1, 2) @ t[0][..., None])[..., 0]
                      for a, t in zip(wJc, tt)], by_cam)
        bp = seg_sum([(a.transpose(1, 2) @ t[0][..., None])[..., 0]
                      for a, t in zip(wJp, tt)], by_pt)

        U = U + lam * I6
        Vinv = _inv3x3(V + lam * I3)
        Y = [w_ @ vi[s.e_pt] for w_, vi, s in zip(W, bcast(Vinv), shards)]  # [E,6,3]

        # reduced rhs = -(bc - sum_e Y_e bp[pt_e]) per camera
        ybp = [(y @ b[s.e_pt][..., None])[..., 0] for y, b, s in zip(Y, bcast(bp), shards)]
        red = bc - seg_sum(ybp, by_cam)  # [C,6]

        if solver == "dense":
            # Schur assembly: S[ci,cj] -= sum over pairs Y_i W_j^T
            contrib = Y[0][p.pair_i] @ W[0][p.pair_j].transpose(-1, -2)
            contrib = contrib * p.pair_valid.to(dtype)[:, None, None]
            S = -_segment_sum(contrib, by_pair).reshape(C, C, 6, 6)
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
                wx = [(w_.transpose(-1, -2) @ xs[s.e_cam][..., None])[..., 0]  # [E,3]
                      for w_, xs, s in zip(W, bcast(x), shards)]
                vp = (Vinv @ seg_sum(wx, by_pt)[..., None])[..., 0]
                back = [(w_ @ v[s.e_pt][..., None])[..., 0]  # [E,6]
                        for w_, v, s in zip(W, bcast(vp), shards)]
                out = ux - seg_sum(back, by_cam)
                return out * free[:, None] + x * (1.0 - free)[:, None]

            # block-Jacobi preconditioner from the self-pair Schur diagonal
            # S_cc ~ U_c - sum_{e in c} Y_e W_e^T
            diag_sub = seg_sum([y @ w_.transpose(-1, -2) for y, w_ in zip(Y, W)], by_cam)
            Sd = U - diag_sub + 1e-6 * I6
            Sd = torch.where(p.cam_fixed[:, None, None], I6, Sd)
            Sd_inv = torch.linalg.inv_ex(Sd)[0]

            def prec(x, Sd_inv=Sd_inv):
                return (Sd_inv @ x[..., None])[..., 0] * free[:, None]

            dc = _pcg_schur(matvec, prec, rhs_c, cg_iters) * free[:, None]

        # landmark back-substitution: dp = -Vinv (bp + W^T dc)
        wt_dc = [(w_.transpose(-1, -2) @ d_[s.e_cam][..., None])[..., 0]  # [E,3]
                 for w_, d_, s in zip(W, bcast(dc), shards)]
        dp = -(Vinv @ (bp + seg_sum(wt_dc, by_pt))[..., None])[..., 0]

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
