"""Two-view epipolar / homography math, batched over RANSAC hypotheses.

PyTorch counterpart of `mono_slam_framework_tpu/geometry/epipolar.py`, the
linear-algebra core of the reference Initializer
(slam_pipeline/src/Initializer.cc): Hartley-style normalization (760-804),
8-point H/F estimation (246-320), symmetric transfer / epipolar scoring
(322-487), essential decomposition (916-934) and the Faugeras homography
decomposition (585-698). Where the JAX package `vmap`s over the hypothesis
axis, these functions take it as a leading batch dim.
"""

from __future__ import annotations

import torch

CHI2_F = 3.841
CHI2_SCORE = 5.991


def normalize_points(xy, valid):
    """Zero-mean, unit mean-absolute-deviation normalization.

    Matches Initializer::Normalize (Initializer.cc:760-804): the scale is
    1/mean(|x - mean|) per axis (not the usual RMS). `valid` masks padding.

    Returns (normalized [N,2], T [3,3]) with x_norm = T @ [x, 1].
    """
    valid_f = valid.to(xy.dtype)
    n = torch.clamp(torch.sum(valid_f), min=1.0)
    mean = torch.sum(xy * valid_f[:, None], dim=0) / n
    centered = (xy - mean) * valid_f[:, None]
    mean_dev = torch.sum(torch.abs(centered), dim=0) / n
    mean_dev = torch.where(mean_dev == 0, torch.ones_like(mean_dev), mean_dev)
    s = 1.0 / mean_dev
    normed = centered * s
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([
        torch.stack([s[0], zero, -mean[0] * s[0]]),
        torch.stack([zero, s[1], -mean[1] * s[1]]),
        torch.stack([zero, zero, one]),
    ])
    return normed, T


def _last_right_singular(A):
    """Right-singular vector of the smallest singular value, [..., 9]. The
    full V is needed only when A has fewer rows than columns (the 8-point
    minimal set); otherwise the reduced SVD has the same V and skips the
    [rows, rows] U of a full-N refit."""
    full = A.shape[-2] < A.shape[-1]
    return torch.linalg.svd(A, full_matrices=full)[2][..., -1, :]


def compute_homography(p1, p2, weights=None):
    """DLT homography from >= 4 correspondences (8 used, Initializer.cc:246-284).

    p1, p2: [..., M, 2] normalized points. Returns H21 [..., 3, 3] with
    p2 ~ H @ p1. Optional `weights` [..., M] zero out rows (masked least
    squares for refits).
    """
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    rows_a = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    rows_b = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    if weights is not None:
        rows_a = rows_a * weights[..., None]
        rows_b = rows_b * weights[..., None]
    A = torch.cat([rows_a, rows_b], dim=-2)  # [..., 2M, 9]
    return _last_right_singular(A).reshape(*A.shape[:-2], 3, 3)


def compute_fundamental(p1, p2, weights=None):
    """8-point fundamental with rank-2 projection (Initializer.cc:286-320).

    p1, p2: [..., M, 2] normalized points. Returns F21 [..., 3, 3] with
    p2' F p1 = 0. Optional `weights` [..., M] zero out rows.
    """
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(u1)
    A = torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], dim=-1
    )  # [..., M, 9]
    if weights is not None:
        A = A * weights[..., None]
    Fpre = _last_right_singular(A).reshape(*A.shape[:-2], 3, 3)
    u, w, vt = torch.linalg.svd(Fpre)
    w = torch.cat([w[..., :2], torch.zeros_like(w[..., 2:])], dim=-1)
    return (u * w[..., None, :]) @ vt


def score_homography(H21, H12, xy1, xy2, valid, sigma):
    """Symmetric transfer-error score (Initializer::CheckHomography, 322-407).

    H21/H12 [..., 3, 3] (a leading hypothesis axis broadcasts over the
    points). Returns (score [...], inlier_mask [..., N]). Outside-threshold
    terms add 0; an inlier needs both directions under chi2 5.991.
    """
    inv_sigma2 = 1.0 / (sigma * sigma)

    def transfer(Hm, a, b):
        # project a with Hm, compare to b
        h = Hm[..., None, :, :]
        w = h[..., 2, 0] * a[:, 0] + h[..., 2, 1] * a[:, 1] + h[..., 2, 2]
        w = torch.where(w == 0, torch.full_like(w, torch.inf), w)
        u = (h[..., 0, 0] * a[:, 0] + h[..., 0, 1] * a[:, 1] + h[..., 0, 2]) / w
        v = (h[..., 1, 0] * a[:, 0] + h[..., 1, 1] * a[:, 1] + h[..., 1, 2]) / w
        d2 = (b[:, 0] - u) ** 2 + (b[:, 1] - v) ** 2
        return d2 * inv_sigma2

    chi2_1 = transfer(H12, xy2, xy1)  # image-2 point mapped into image 1
    chi2_2 = transfer(H21, xy1, xy2)
    in1 = (chi2_1 <= CHI2_SCORE) & valid
    in2 = (chi2_2 <= CHI2_SCORE) & valid
    score = torch.sum(torch.where(in1, CHI2_SCORE - chi2_1, 0.0), dim=-1) + torch.sum(
        torch.where(in2, CHI2_SCORE - chi2_2, 0.0), dim=-1
    )
    return score, in1 & in2


def score_fundamental(F21, xy1, xy2, valid, sigma):
    """Epipolar-distance score (Initializer::CheckFundamental, 409-487).

    Scores against chi2 3.841 but accumulates (5.991 - chi2) per direction,
    matching the reference's asymmetric th/thScore constants. F21
    [..., 3, 3]; returns (score [...], inlier_mask [..., N]).
    """
    inv_sigma2 = 1.0 / (sigma * sigma)
    o = torch.ones_like(xy1[:, 0])
    x1 = torch.stack([xy1[:, 0], xy1[:, 1], o], dim=-1)
    x2 = torch.stack([xy2[:, 0], xy2[:, 1], o], dim=-1)
    l2 = x1 @ F21.transpose(-1, -2)  # epipolar line in image 2 of x1
    l1 = x2 @ F21  # epipolar line in image 1 of x2
    num2 = torch.sum(l2 * x2, dim=-1)
    num1 = torch.sum(l1 * x1, dim=-1)
    d2_2 = num2 * num2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-20)
    d2_1 = num1 * num1 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-20)
    chi2_2 = d2_2 * inv_sigma2
    chi2_1 = d2_1 * inv_sigma2
    in2 = (chi2_2 <= CHI2_F) & valid
    in1 = (chi2_1 <= CHI2_F) & valid
    score = torch.sum(torch.where(in2, CHI2_SCORE - chi2_2, 0.0), dim=-1) + torch.sum(
        torch.where(in1, CHI2_SCORE - chi2_1, 0.0), dim=-1
    )
    return score, in1 & in2


def _flip_to_proper(R):
    return torch.where(torch.linalg.det(R)[..., None, None] < 0, -R, R)


def decompose_essential(E):
    """E -> (R1, R2, t) candidate motions (Initializer::DecomposeE, 916-934).

    t is unit-norm; the caller tries +-t with both rotations.
    """
    u, _, vt = torch.linalg.svd(E)
    t = u[:, 2]
    t = t / torch.linalg.norm(t)
    W = torch.tensor(
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
        dtype=E.dtype, device=E.device,
    )
    R1 = _flip_to_proper(u @ W @ vt)
    R2 = _flip_to_proper(u @ W.T @ vt)
    return R1, R2, t


def decompose_homography_faugeras(H21, K):
    """Faugeras decomposition of a homography into 8 motion hypotheses.

    Mirrors Initializer::ReconstructH's hypothesis generation
    (Initializer.cc:599-698). Returns (Rs [8,3,3], ts [8,3], ok) where ok is
    False when the singular values are too close (degenerate, 612-614); the
    outputs are then garbage and must be ignored.
    """
    A = torch.linalg.inv(K) @ H21 @ K
    U, w, Vt = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    ok = (d1 / d2 >= 1.00001) & (d2 / d3 >= 1.00001)

    eps = 1e-12
    denom13 = d1 * d1 - d3 * d3 + eps
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom13, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom13, min=0.0))
    sgn1 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=H21.dtype, device=H21.device)
    sgn3 = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=H21.dtype, device=H21.device)
    sgn_s = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=H21.dtype, device=H21.device)
    x1, x3 = aux1 * sgn1, aux3 * sgn3
    prod = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    zero, one = torch.zeros_like(x1), torch.ones_like(x1)

    def motions(c, sn, case2):
        """Four (R, t) of one case: d' = d2 (Rp about y, det +1) or
        d' = -d2 (a reflection composed in, t with +x3)."""
        c = c.expand(4)
        if not case2:
            Rp = torch.stack([
                torch.stack([c, zero, -sn], -1),
                torch.stack([zero, one, zero], -1),
                torch.stack([sn, zero, c], -1),
            ], -2)
            tp = torch.stack([x1, zero, -x3], -1) * (d1 - d3)
        else:
            Rp = torch.stack([
                torch.stack([c, zero, sn], -1),
                torch.stack([zero, -one, zero], -1),
                torch.stack([sn, zero, -c], -1),
            ], -2)
            tp = torch.stack([x1, zero, x3], -1) * (d1 + d3)
        R = s * U @ Rp @ Vt
        t = tp @ U.T
        t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=eps)
        return R, t

    # case d' = d2
    den1 = (d1 + d3) * d2 + eps
    R_a, t_a = motions((d2 * d2 + d1 * d3) / den1, prod / den1 * sgn_s, False)
    # case d' = -d2
    den2 = (d1 - d3) * d2 + eps
    R_b, t_b = motions((d1 * d3 - d2 * d2) / den2, prod / den2 * sgn_s, True)
    return torch.cat([R_a, R_b]), torch.cat([t_a, t_b]), ok
