"""Trajectory I/O and evaluation (ATE / RPE).

A copy of `mono_slam_framework_tpu/io/trajectory.py` (numpy only).

The reference's only machine-checkable output is the TUM-format keyframe
trajectory (System.cc:89-122), intended for offline ATE evaluation against
ground truth (SURVEY.md §4). This module provides the TUM read/write side plus
ATE-RMSE with Umeyama similarity alignment and RPE, so the framework carries
its own evaluation harness.
"""

from __future__ import annotations

import numpy as np


def read_tum(path: str):
    """Read `t x y z qx qy qz qw` lines -> (times [N], pos [N,3], quat [N,4])."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) >= 8:
                rows.append(vals[:8])
    arr = np.asarray(rows)
    if arr.size == 0:
        return np.zeros(0), np.zeros((0, 3)), np.zeros((0, 4))
    return arr[:, 0], arr[:, 1:4], arr[:, 4:8]


def write_tum(path: str, times, pos, quat) -> None:
    with open(path, "w") as f:
        for t, p, q in zip(times, pos, quat):
            f.write(
                f"{t:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def associate(times_a, times_b, max_dt: float = 0.02):
    """Greedy nearest-timestamp association (the standard TUM tool behavior)."""
    ia, ib = [], []
    j = 0
    for i, ta in enumerate(times_a):
        # advance j to the closest tb
        while j + 1 < len(times_b) and abs(times_b[j + 1] - ta) <= abs(
            times_b[j] - ta
        ):
            j += 1
        if len(times_b) and abs(times_b[j] - ta) <= max_dt:
            ia.append(i)
            ib.append(j)
    return np.asarray(ia, int), np.asarray(ib, int)


def umeyama_alignment(src, dst, with_scale: bool = True):
    """Similarity transform s,R,t minimizing ||dst - (s R src + t)||."""
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


def ate_rmse(times_est, pos_est, times_gt, pos_gt, with_scale: bool = True):
    """Absolute trajectory error RMSE after Umeyama alignment.

    Monocular SLAM is scale-ambiguous, so scale-aligned ATE (Sim3) is the
    standard metric.
    """
    ia, ib = associate(times_est, times_gt)
    if len(ia) < 3:
        return float("inf"), 0
    a = pos_est[ia]
    b = pos_gt[ib]
    s, R, t = umeyama_alignment(a, b, with_scale)
    aligned = (s * (R @ a.T)).T + t
    err = np.linalg.norm(aligned - b, axis=1)
    return float(np.sqrt(np.mean(err**2))), len(ia)


def rpe_rmse(times_est, pos_est, times_gt, pos_gt, delta: int = 1):
    """Relative pose (translation drift) error RMSE over `delta`-step pairs."""
    ia, ib = associate(times_est, times_gt)
    if len(ia) <= delta:
        return float("inf"), 0
    a = pos_est[ia]
    b = pos_gt[ib]
    da = a[delta:] - a[:-delta]
    db = b[delta:] - b[:-delta]
    # align scale only (direction differences are the signal)
    na = np.linalg.norm(da, axis=1).sum()
    nb = np.linalg.norm(db, axis=1).sum()
    s = nb / na if na > 0 else 1.0
    err = np.linalg.norm(s * da - db, axis=1)
    return float(np.sqrt(np.mean(err**2))), len(da)
