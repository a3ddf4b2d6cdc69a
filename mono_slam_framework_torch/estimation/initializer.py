"""Two-view SfM bootstrap: batched H/F RANSAC + model selection + CheckRT.

PyTorch counterpart of `mono_slam_framework_tpu/estimation/initializer.py`
(the reference Initializer, slam_pipeline/src/Initializer.cc): 200-iteration
8-point RANSAC for a homography and a fundamental matrix (99-135), model
selection RH = SH/(SH+SF) > 0.40 (137-147), ReconstructF via essential
decomposition with 4 hypotheses (489-583), ReconstructH via Faugeras with
8 hypotheses (585-742), cheirality/reprojection/parallax gating in CheckRT
(806-914).

All 200 hypotheses are estimated and scored in one batched call: the
minimal-set SVDs are [200,16,9] / [200,8,9], scoring is a [200,N]
broadcast, and reconstruction triangulates every correspondence for every
motion hypothesis at once. Randomness is an explicit, seeded
`torch.Generator` (the JAX package's `jax.random` key; both fix reference
quirk B8, fresh std::random_device seeds per call). The uniforms are drawn
on the generator's device and moved to the computation's: Tracking keeps
its generator on the host, so one seed draws the same minimal sets on the
CPU and on the card (a CUDA generator's Philox stream is another stream).
The JAX package's stream differs too, so the two packages draw other
minimal sets from the same seed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mono_slam_framework_torch.geometry import epipolar, triangulation


class InitResult(NamedTuple):
    success: bool
    R21: np.ndarray  # [3,3] rotation of camera 2 w.r.t. camera 1
    t21: np.ndarray  # [3]
    points3d: np.ndarray  # [N,3] in camera-1 (=world) frame
    triangulated: np.ndarray  # bool [N]
    used_homography: bool


def _sample_minimal_sets(generator, valid, iterations):
    """[iterations, 8] distinct valid indices via random-key top-k."""
    r = torch.rand(
        (iterations, valid.shape[0]), generator=generator, device=generator.device
    ).to(valid.device)
    r = torch.where(valid[None, :], r, -torch.inf)
    return torch.topk(r, 8, dim=1).indices


def ransac_h_f(xy1, xy2, valid, generator, sigma, iterations=200):
    """Batched H and F RANSAC over shared minimal sets (Initializer.cc:99-135).

    Returns (H21, score_h, inliers_h, F21, score_f, inliers_f).
    """
    n1, T1 = epipolar.normalize_points(xy1, valid)
    n2, T2 = epipolar.normalize_points(xy2, valid)
    sets = _sample_minimal_sets(generator, valid, iterations)  # [it, 8]
    p1 = n1[sets]  # [it, 8, 2]
    p2 = n2[sets]

    T2inv = torch.linalg.inv(T2)
    H = T2inv @ epipolar.compute_homography(p1, p2) @ T1  # [it, 3, 3]
    F = T2.T @ epipolar.compute_fundamental(p1, p2) @ T1

    def score_h(Hi):
        return epipolar.score_homography(
            Hi, torch.linalg.inv_ex(Hi)[0], xy1, xy2, valid, sigma
        )

    def score_f(Fi):
        return epipolar.score_fundamental(Fi, xy1, xy2, valid, sigma)

    sh, inl_h = score_h(H)
    sf, inl_f = score_f(F)
    bh = torch.argmax(sh)
    bf = torch.argmax(sf)

    # Refit on all RANSAC inliers (masked full-N DLT) and rescore: the JAX
    # package's deliberate divergence from the raw minimal-set model of
    # Initializer.cc:185-196, kept here.
    H_refit = T2inv @ epipolar.compute_homography(n1, n2, inl_h[bh].to(xy1.dtype)) @ T1
    F_refit = T2.T @ epipolar.compute_fundamental(n1, n2, inl_f[bf].to(xy1.dtype)) @ T1
    sh2, inl_h2 = score_h(H_refit)
    sf2, inl_f2 = score_f(F_refit)
    # keep whichever of raw/refit scores higher
    use_h2 = sh2 > sh[bh]
    use_f2 = sf2 > sf[bf]
    return (
        torch.where(use_h2, H_refit, H[bh]),
        torch.where(use_h2, sh2, sh[bh]),
        torch.where(use_h2, inl_h2, inl_h[bh]),
        torch.where(use_f2, F_refit, F[bf]),
        torch.where(use_f2, sf2, sf[bf]),
        torch.where(use_f2, inl_f2, inl_f[bf]),
    )


def check_rt(R, t, xy1, xy2, inliers, K, th2):
    """Triangulate + gate motion hypotheses (Initializer::CheckRT, 806-914).

    R [B,3,3], t [B,3] hypotheses; xy1/xy2 [N,2], inliers bool [N].
    Returns (ngood [B], parallax_deg [B], X [B,N,3], good bool [B,N]).
    """
    zero = torch.zeros((3, 1), dtype=K.dtype, device=K.device)
    P1 = torch.cat([K, zero], dim=1)
    P2 = K @ torch.cat([R, t[..., None]], dim=-1)
    X, w = triangulation.triangulate_dlt(xy1, xy2, P1, P2)
    finite = torch.isfinite(X).all(dim=-1) & (w != 0)

    O2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]  # [B, 3]
    n2v = X - O2[:, None, :]
    d1 = torch.linalg.norm(X, dim=-1)  # camera-1 center is the origin
    d2 = torch.linalg.norm(n2v, dim=-1)
    denom = torch.where(d1 * d2 == 0, torch.ones_like(d1), d1 * d2)
    cos_par = torch.sum(X * n2v, dim=-1) / denom

    Xc2 = X @ R.transpose(-1, -2) + t[:, None, :]
    # depth gates apply only when parallax is meaningful (806-873)
    z1_ok = (X[..., 2] > 0) | (cos_par >= 0.99998)
    z2_ok = (Xc2[..., 2] > 0) | (cos_par >= 0.99998)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def reproj_err(Xc, uv):
        z = torch.where(Xc[..., 2] == 0, torch.ones_like(Xc[..., 2]), Xc[..., 2])
        u = fx * Xc[..., 0] / z + cx
        v = fy * Xc[..., 1] / z + cy
        return (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2

    counted = (
        inliers & finite & z1_ok & z2_ok
        & (reproj_err(X, xy1) <= th2) & (reproj_err(Xc2, xy2) <= th2)
    )
    ngood = torch.sum(counted, dim=-1)
    # vbGood additionally requires real parallax (Initializer.cc:902)
    good = counted & (cos_par < 0.99998)

    # parallax at the 50th-smallest cos among counted points (905-911)
    cos_sorted = torch.sort(torch.where(counted, cos_par, torch.inf), dim=-1).values
    idx = torch.clamp(ngood - 1, min=0).clamp(max=50)
    pick = torch.clamp(torch.gather(cos_sorted, 1, idx[:, None])[:, 0], -1.0, 1.0)
    parallax = torch.where(
        ngood > 0, torch.rad2deg(torch.arccos(pick)), torch.zeros_like(pick)
    )
    return ngood, parallax, X, good


def reconstruct_f(F21, K, xy1, xy2, inliers, sigma2, min_parallax, min_triangulated):
    """4-hypothesis essential reconstruction (Initializer::ReconstructF)."""
    E = K.T @ F21 @ K
    R1, R2, t = epipolar.decompose_essential(E)
    Rs = torch.stack([R1, R2, R1, R2])
    ts = torch.stack([t, t, -t, -t])
    ngood, par, X, good = check_rt(Rs, ts, xy1, xy2, inliers, K, 4.0 * sigma2)

    N = torch.sum(inliers)
    max_good = torch.max(ngood)
    n_min_good = torch.clamp((0.9 * N).to(torch.int64), min=int(min_triangulated))
    nsimilar = torch.sum(ngood > 0.7 * max_good)
    best = torch.argmax(ngood)
    ok = (max_good >= n_min_good) & (nsimilar == 1) & (par[best] > min_parallax)
    return ok, Rs[best], ts[best], X[best], good[best]


def reconstruct_h(H21, K, xy1, xy2, inliers, sigma2, min_parallax, min_triangulated):
    """8-hypothesis Faugeras reconstruction (Initializer::ReconstructH).

    The JAX package's deliberate divergence from Initializer.cc:730-731 is
    kept: distinct winner + 90 % support + minTriangulated + parallax.
    """
    Rs, ts, decomp_ok = epipolar.decompose_homography_faugeras(H21, K)
    ngood, par, X, good = check_rt(Rs, ts, xy1, xy2, inliers, K, 4.0 * sigma2)

    N = torch.sum(inliers)
    best = torch.argmax(ngood)
    others = torch.where(
        torch.arange(8, device=ngood.device) == best, -1, ngood
    )
    second_best = torch.max(others)
    ok = (
        decomp_ok
        & (second_best < 0.75 * ngood[best])
        & (par[best] >= min_parallax)
        & (ngood[best] >= min_triangulated)
        & (ngood[best] > (0.9 * N).to(torch.int64))
    )
    return ok, Rs[best], ts[best], X[best], good[best]


def _essential_direct(xy1, xy2, valid, K, sigma):
    """Direct (no-RANSAC) essential bootstrap, the counterpart of the
    reference's alternate Initializer::InitializeOpenCV (Initializer.cc:39-73):
    fit F on ALL correspondences, decompose, pick by cheirality vote."""
    n1, T1 = epipolar.normalize_points(xy1, valid)
    n2, T2 = epipolar.normalize_points(xy2, valid)
    F = T2.T @ epipolar.compute_fundamental(n1, n2, valid.to(xy1.dtype)) @ T1
    _, inl = epipolar.score_fundamental(F, xy1, xy2, valid, sigma)
    R1, R2, t = epipolar.decompose_essential(K.T @ F @ K)
    Rs = torch.stack([R1, R2, R1, R2])
    ts = torch.stack([t, t, -t, -t])
    ngood, _, X, good = check_rt(Rs, ts, xy1, xy2, inl, K, 4.0 * sigma * sigma)
    best = torch.argmax(ngood)
    return Rs[best], ts[best], X[best], good[best], ngood[best]


def _np(x):
    return x.detach().cpu().numpy()


class Initializer:
    """Host-side entry with the reference's selection policy
    (Initializer::Initialize, Initializer.cc:75-150): run both models, pick by
    RH = SH/(SH+SF) > 0.40, reconstruct with the chosen model only (with
    `model_fallback`, retry the other one when it fails). Runs on the device
    of `device`."""

    def __init__(
        self,
        K: np.ndarray,
        sigma: float = 1.0,
        iterations: int = 200,
        model_fallback: bool = False,
        device: torch.device | str = "cuda",
    ):
        self.device = torch.device(device)
        self.K = torch.as_tensor(np.asarray(K, np.float32), device=self.device)
        self.sigma = float(sigma)
        self.iterations = int(iterations)
        self.model_fallback = bool(model_fallback)

    def _inputs(self, xy1, xy2, valid):
        """Host arrays -> device tensors; at least 8 rows so the minimal-set
        top-k always has 8 slots (extra rows are invalid)."""
        n = int(np.asarray(xy1).shape[0])
        rows = max(n, 8)
        xy1p = np.zeros((rows, 2), np.float32)
        xy2p = np.zeros((rows, 2), np.float32)
        validp = np.zeros(rows, bool)
        xy1p[:n] = xy1
        xy2p[:n] = xy2
        validp[:n] = True if valid is None else np.asarray(valid, bool)

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        return n, dev(xy1p), dev(xy2p), dev(validp)

    def initialize(
        self,
        xy1: np.ndarray,
        xy2: np.ndarray,
        generator: torch.Generator,
        min_triangulated: int = 25,
        min_parallax: float = 1.1,
        valid: np.ndarray | None = None,
    ) -> InitResult:
        n, xy1, xy2, valid_t = self._inputs(xy1, xy2, valid)
        H, sh, inl_h, F, sf, inl_f = ransac_h_f(
            xy1, xy2, valid_t, generator, self.sigma, self.iterations
        )
        sh, sf = float(sh), float(sf)
        rh = sh / max(sh + sf, 1e-9)
        sigma2 = self.sigma * self.sigma

        def try_h():
            return reconstruct_h(
                H, self.K, xy1, xy2, inl_h, sigma2, min_parallax, min_triangulated
            )

        def try_f():
            return reconstruct_f(
                F, self.K, xy1, xy2, inl_f, sigma2, min_parallax, min_triangulated
            )

        # model selection per the reference (RH > 0.40, Initializer.cc:142);
        # with model_fallback (opt-in) a failed reconstruction retries the
        # other model in the same attempt
        used_h = rh > 0.40
        ok, R, t, X, good = try_h() if used_h else try_f()
        if self.model_fallback and not bool(ok):
            alt = try_f() if used_h else try_h()
            if bool(alt[0]):
                ok, R, t, X, good = alt
                used_h = not used_h
        return InitResult(
            success=bool(ok),
            R21=_np(R),
            t21=_np(t),
            points3d=_np(X)[:n],
            triangulated=_np(good)[:n],
            used_homography=used_h,
        )

    def initialize_direct(
        self,
        xy1: np.ndarray,
        xy2: np.ndarray,
        min_triangulated: int = 25,
        valid: np.ndarray | None = None,
    ) -> InitResult:
        """Non-RANSAC essential bootstrap (the reference's InitializeOpenCV
        alternate, Initializer.cc:39-73), an independent oracle."""
        n, xy1, xy2, valid_t = self._inputs(xy1, xy2, valid)
        R, t, X, good, ngood = _essential_direct(xy1, xy2, valid_t, self.K, self.sigma)
        return InitResult(
            success=bool(ngood > min_triangulated),
            R21=_np(R),
            t21=_np(t),
            points3d=_np(X)[:n],
            triangulated=_np(good)[:n],
            used_homography=False,
        )
