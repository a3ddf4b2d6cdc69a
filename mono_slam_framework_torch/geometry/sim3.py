"""Host-side Sim(3) utilities for loop-closure pre-alignment.

A copy of `mono_slam_framework_tpu/geometry/sim3.py` (numpy only): the port
imports nothing of the JAX package.

The reference fork's CorrectLoop is a global BA with no pre-alignment
(slam_pipeline/src/LoopClosing.cc:101-115) — upstream
ORB-SLAM2 instead computes a Sim3 for the loop keyframe, propagates it to
the covisible window, fuses duplicates, and only then optimizes (its
LoopClosing::CorrectLoop / OptimizeEssentialGraph). The fork's measured
behavior on a genuine loop is a no-op: by the time the GBA runs, the drift
gap is far outside its basin (quality_bench: ate_loop_before ==
ate_loop_after at ~1.24 ATE on the rect-loop hard world, fuse on or off).

This module provides the exact Sim(3) exp/log (Strasdat's closed form) used
by `slam/loop_closing.py` to distribute the measured loop correction along
the keyframe chain (`G^w = exp(w·log G)` per keyframe) before duplicate
fusion and the polishing GBA — monocular drift includes scale, hence Sim(3)
rather than SE(3).

All host-side numpy: loop closing is host orchestration over a handful of
keyframes; the heavy optimization that follows (GBA) is the device program.
"""

from __future__ import annotations

import numpy as np


def _hat(w: np.ndarray) -> np.ndarray:
    return np.array(
        [
            [0.0, -w[2], w[1]],
            [w[2], 0.0, -w[0]],
            [-w[1], w[0], 0.0],
        ]
    )


def log_so3(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = float(np.arccos(cos))
    if theta < 1e-10:
        return np.array(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
        ) * 0.5
    if theta > np.pi - 1e-6:
        # near-pi: axis from the symmetric part. (1-cosθ)·aaᵀ =
        # (R+Rᵀ)/2 - cosθ·I; take the largest-diagonal column and
        # orient it with the antisymmetric part.
        M = ((R + R.T) * 0.5 - cos * np.eye(3)) / (1.0 - cos)
        i = int(np.argmax(np.diag(M)))
        axis = M[:, i] / max(np.sqrt(max(M[i, i], 1e-12)), 1e-12)
        skew = np.array(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
        )
        if np.dot(axis, skew) < 0:
            axis = -axis
        return axis / max(np.linalg.norm(axis), 1e-12) * theta
    return (
        np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        * theta
        / (2.0 * np.sin(theta))
    )


def exp_so3(w: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(w))
    W = _hat(w)
    if theta < 1e-10:
        return np.eye(3) + W + 0.5 * (W @ W)
    return (
        np.eye(3)
        + (np.sin(theta) / theta) * W
        + ((1.0 - np.cos(theta)) / theta**2) * (W @ W)
    )


def _sim3_W(sigma: float, w: np.ndarray) -> np.ndarray:
    """W(sigma, omega) = ∫₀¹ e^{sigma·u} e^{[omega]× u} du — the matrix with
    t = W·upsilon in the Sim(3) exponential (Strasdat, "Scale drift-aware
    large scale monocular SLAM", RSS'10)."""
    theta = float(np.linalg.norm(w))
    Om = _hat(w)
    # ∫ e^{su} du
    if abs(sigma) < 1e-8:
        C = 1.0 + sigma * 0.5
    else:
        C = (np.exp(sigma) - 1.0) / sigma
    if theta < 1e-8:
        # series in theta: ∫ e^{su} u du and ∫ e^{su} u²/2 du
        if abs(sigma) < 1e-8:
            a = 0.5 + sigma / 3.0
            b = 1.0 / 6.0 + sigma / 8.0
        else:
            es = np.exp(sigma)
            a = (es * (sigma - 1.0) + 1.0) / sigma**2
            b = (es * (sigma**2 - 2.0 * sigma + 2.0) - 2.0) / (2.0 * sigma**3)
        return C * np.eye(3) + a * Om + b * (Om @ Om)
    es = np.exp(sigma)
    den = sigma**2 + theta**2
    s_int = (es * (sigma * np.sin(theta) - theta * np.cos(theta)) + theta) / den
    c_int = (es * (sigma * np.cos(theta) + theta * np.sin(theta)) - sigma) / den
    return (
        C * np.eye(3)
        + (s_int / theta) * Om
        + ((C - c_int) / theta**2) * (Om @ Om)
    )


def log_sim3(s: float, R: np.ndarray, t: np.ndarray):
    """(s, R, t) -> tangent (sigma, omega [3], upsilon [3])."""
    sigma = float(np.log(s))
    w = log_so3(np.asarray(R, float))
    W = _sim3_W(sigma, w)
    ups = np.linalg.solve(W, np.asarray(t, float))
    return sigma, w, ups


def exp_sim3(sigma: float, w: np.ndarray, ups: np.ndarray):
    """Tangent -> (s, R, t)."""
    s = float(np.exp(sigma))
    R = exp_so3(np.asarray(w, float))
    t = _sim3_W(sigma, np.asarray(w, float)) @ np.asarray(ups, float)
    return s, R, t


def sim3_power(s: float, R: np.ndarray, t: np.ndarray, alpha: float):
    """G^alpha = exp(alpha · log G): the fractional similarity used to
    distribute a loop correction smoothly along the keyframe chain."""
    if alpha <= 0.0:
        return 1.0, np.eye(3), np.zeros(3)
    if alpha >= 1.0:
        return float(s), np.asarray(R, float), np.asarray(t, float)
    sigma, w, ups = log_sim3(s, R, t)
    return exp_sim3(alpha * sigma, alpha * w, alpha * ups)


def apply_sim3(s: float, R: np.ndarray, t: np.ndarray, X: np.ndarray):
    """X' = s R X + t (X [..., 3])."""
    return s * (np.asarray(X, float) @ np.asarray(R, float).T) + np.asarray(
        t, float
    )


def _umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool):
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var) if var > 0 else 1.0
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def rotation_angle(R: np.ndarray) -> float:
    return float(
        np.arccos(np.clip((np.trace(np.asarray(R, float)) - 1.0) * 0.5, -1, 1))
    )


def fit_sim3_robust(
    new_pts: np.ndarray,
    old_pts: np.ndarray,
    scale_bounds: tuple = (0.5, 2.0),
    max_angle: float = 0.6,
    trim_rounds: int = 2,
):
    """Robust similarity fit old ≈ s·R·new + t for loop pre-alignment.

    Loop duplicate pairs are FEW and partly WRONG (ratio-test survivors
    across a drift gap), and Umeyama's closed-form scale tr(DS)/var
    collapses toward 0 under uncorrelated matches — a raw fit once measured
    scale 0.006 on a real loop and crushed the whole revisit map. Hierarchy
    with sanity gates instead:

      1. residual-trimmed Umeyama Sim(3): accept if scale within
         `scale_bounds` and rotation below `max_angle` (monocular drift
         over one loop is a small correction, never a 166x shrink);
      2. else the SE(3) fit (scale pinned 1), same rotation gate;
      3. else pure translation (component-wise median of old - new) —
         always well-posed down to a handful of pairs.

    Whatever model wins must IMPROVE the pairs' median residual vs the
    identity (no correction) or None is returned — insurance that a
    degenerate pair set can never scramble the map.
    """
    new_pts = np.asarray(new_pts, float)
    old_pts = np.asarray(old_pts, float)
    n = len(new_pts)
    if n < 4:
        return None

    # robust seed: inliers under the translation-median floor model (a raw
    # least-squares seed lets 25% wild outliers poison the first fit so
    # badly the trim can no longer separate them)
    t_med = np.median(old_pts - new_pts, axis=0)
    res_seed = np.linalg.norm(old_pts - new_pts - t_med, axis=1)
    keep_seed = res_seed <= 3.0 * max(float(np.median(res_seed)), 1e-9)

    def trimmed(with_scale: bool):
        keep = keep_seed.copy()
        fit = None
        for _ in range(trim_rounds):
            if keep.sum() < 4:
                break
            fit = _umeyama(new_pts[keep], old_pts[keep], with_scale)
            res = np.linalg.norm(
                apply_sim3(*fit, new_pts) - old_pts, axis=1
            )
            med = float(np.median(res[keep]))
            keep = res <= 3.0 * max(med, 1e-9)
        return fit

    candidates = []
    fit = trimmed(with_scale=True)
    if (
        fit is not None
        and scale_bounds[0] <= fit[0] <= scale_bounds[1]
        and rotation_angle(fit[1]) <= max_angle
    ):
        candidates.append(fit)
    if not candidates:
        fit = trimmed(with_scale=False)
        if fit is not None and rotation_angle(fit[1]) <= max_angle:
            candidates.append(fit)
    # translation-only floor model
    candidates.append((1.0, np.eye(3), t_med))

    res0 = float(
        np.median(np.linalg.norm(old_pts - new_pts, axis=1))
    )
    best, best_res = None, res0
    for s, R, t in candidates:
        res = float(
            np.median(
                np.linalg.norm(apply_sim3(s, R, t, new_pts) - old_pts, axis=1)
            )
        )
        if res < best_res:
            best, best_res = (s, R, t), res
    return best


def corrected_pose(Tcw: np.ndarray, s: float, R: np.ndarray, t: np.ndarray):
    """SE(3) camera pose after correcting the WORLD by X' = s R X + t.

    Derivation: x_cam = R_k X + t_k with X = G⁻¹(X') gives, up to the
    per-camera uniform depth rescale s (projection-invariant),
    R' = R_k Rᵀ, t' = s t_k − R' t — upstream ORB-SLAM2's
    CorrectedSim3 → SE3 conversion ([sR|t] → [R | t/s]) in world-correction
    form."""
    Tcw = np.asarray(Tcw, float)
    Rk, tk = Tcw[:3, :3], Tcw[:3, 3]
    Rp = Rk @ np.asarray(R, float).T
    tp = float(s) * tk - Rp @ np.asarray(t, float)
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = Rp
    out[:3, 3] = tp
    return out
