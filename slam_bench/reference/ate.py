"""Absolute trajectory error of tracked poses against the rendered ground
truth, after the similarity alignment that monocular SLAM's unknown scale
asks for.

Frozen copy of `mono_slam_framework_torch/io/trajectory.py:59-94`
(`umeyama_alignment`, `ate_rmse` with scale), in float64 NumPy, taking
camera centres directly (the frames are paired by index, not timestamp).
"""

from __future__ import annotations

import numpy as np


def centres(Tcw: np.ndarray) -> np.ndarray:
    """Camera centres [N, 3] of world->camera poses [N, 4, 4]."""
    T = np.asarray(Tcw, np.float64)
    return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])


def umeyama_alignment(src: np.ndarray, dst: np.ndarray):
    """Similarity s, R, t minimizing ||dst - (s R src + t)||."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var) if var > 0 else 1.0
    return s, R, mu_d - s * R @ mu_s


def ate_rmse(est_Tcw: np.ndarray, gt_Tcw: np.ndarray) -> float:
    """RMS distance between the aligned estimated centres and the true ones."""
    a, b = centres(est_Tcw), centres(gt_Tcw)
    s, R, t = umeyama_alignment(a, b)
    err = np.linalg.norm((s * (R @ a.T)).T + t - b, axis=1)
    return float(np.sqrt(np.mean(err**2)))
