"""Tracking, kernel B2: every sampled frame that the tracker reports as
tracked (OK, and not the frame that initialized it) must carry the pose of
one of that operation's pose solves, bit for bit (`pose_unmatched` counts
those that do not: an answer that never came), and that pose must agree
with the reference LM run on the same solve's inputs (`pose_px`: over the
frames, the largest RMS distance in pixels between the reference's inlier
points projected by the program's pose and by the reference's; a pose
compared entry by entry also differs along the directions the points
barely constrain, where a 10-iteration LM stops short and rounding alone
moves it).

Wraps `pose_opt.pose_optimize` and `pose_optimize_batched` (kernel B2 on a
card): on a sampled operation it keeps every solve's inputs and outputs.
The control runs the reference LM with TF32 products.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_bench import compare
from slam_bench.reference import pose_lm as ref_pose

NUMBERS = ("pose_checked", "pose_unmatched", "pose_px")
CONTROL_MODE = "tf32"
POSE_OPT = "mono_slam_framework_torch.optim.pose_opt"


def wrappers(op) -> dict:
    def make(batched: bool):
        def wrap(real):
            def wrapped(T_init, Xw, uv, valid, K, info=None):
                out = real(T_init, Xw, uv, valid, K, info)
                if op.sampled:
                    args = (T_init, Xw, uv, valid, K, info)
                    if not batched:
                        args = tuple(None if a is None else a[None] for a in args)
                        res = tuple(o[None] for o in out)
                    else:
                        res = out
                    op.kept.append((tuple(compare.clone(a) for a in args),
                                    tuple(compare.clone(o) for o in res)))
                return out
            return wrapped
        return wrap
    return {f"{POSE_OPT}:pose_optimize": make(False), f"{POSE_OPT}:pose_optimize_batched": make(True)}


def _pose_problems(records, diagnose=None):
    """(inputs of the matched solve, reported pose) per tracked sampled
    frame, and the count of tracked frames no solve of their operation
    produced."""
    found, unmatched = [], 0
    for rec in records:
        host = [(args, out[0].cpu().numpy()) for args, out in rec["kept"]]
        for _, before, after, pose in rec["frames"]:
            if after != "OK" or before not in compare.TRACKED_FROM:
                continue
            hit = next(((args, b) for args, T in host for b in range(len(T))
                        if pose is not None and np.array_equal(T[b], pose)), None)
            if hit is None:
                unmatched += 1
                continue
            args, b = hit
            found.append((tuple(None if a is None else a[b : b + 1] for a in args), pose))
            if diagnose is not None:
                out = next(o for a, o in rec["kept"] if a is args)
                diagnose.append(out[1][b].cpu())
    return found, unmatched


def _pose_lm_groups(problems, mode, inliers=None):
    """The reference LM over every problem, batched by edge count (with
    `inliers`, also each problem's inlier mask)."""
    out = [None] * len(problems)
    by_e: dict = {}
    for i, (args, _) in enumerate(problems):
        by_e.setdefault(args[1].shape[1], []).append(i)
    for idx in by_e.values():
        cols = list(zip(*(problems[i][0] for i in idx)))
        T0, Xw, uv, valid, K = (torch.cat(c) for c in cols[:5])
        info = None if cols[5][0] is None else torch.cat(cols[5])
        T, inl, _ = ref_pose.pose_lm(T0, Xw, uv, valid, K, info, mode=mode)
        T = T.cpu().numpy()
        for j, i in enumerate(idx):
            out[i] = T[j]
            if inliers is not None:
                inliers[i] = inl[j].cpu()
    return out


def _gap(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(a[:3, :4].astype(np.float64) - b[:3, :4].astype(np.float64))))


def _px(args, inlier, T_ref: np.ndarray, T: np.ndarray) -> float:
    """RMS over the reference's inlier edges of the pixel distance between
    their projections under T and under T_ref (float64 on the host)."""
    X = args[1][0][inlier[0] if inlier.dim() > 1 else inlier].double().cpu().numpy()
    if not len(X):
        return 0.0
    K = args[4][0].double().cpu().numpy()

    def proj(P):
        Xc = X @ P[:3, :3].astype(np.float64).T + P[:3, 3].astype(np.float64)
        return (Xc[:, :2] / Xc[:, 2:3]) * np.diag(K)[:2] + K[:2, 2]

    return float(np.sqrt(np.mean(np.sum((proj(T) - proj(T_ref)) ** 2, axis=-1))))


def judge(records, config: dict, control: bool) -> tuple[dict, dict]:
    prog_inl: list | None = [] if control else None
    problems, unmatched = _pose_problems(records, prog_inl)
    nums = {"pose_checked": len(problems), "pose_unmatched": unmatched, "pose_px": 0.0}
    ctrl: dict = {}
    if problems:
        ref_inl = [None] * len(problems)
        ref = _pose_lm_groups(problems, "f32", ref_inl)
        pxs = [_px(args, inl, r, pose) for (args, pose), inl, r in zip(problems, ref_inl, ref)]
        nums["pose_px"] = max(pxs)
        if control:
            low = _pose_lm_groups(problems, CONTROL_MODE)
            lows = [_px(a, inl, r, c) for (a, _), inl, r, c in zip(problems, ref_inl, ref, low)]
            ctrl["pose_px"] = max(lows)
            # where the program's widest gaps come from: the gap by quantile
            # on both sides, the widest frames' pose-entry gaps and how many
            # of their edges the program and the reference class differently
            q = [0.1, 0.5, 0.9, 1.0]
            ctrl["pose_px_quantiles"] = {"program": np.quantile(pxs, q).tolist(),
                                         "control": np.quantile(lows, q).tolist()}
            top = sorted(range(len(pxs)), key=lambda i: -pxs[i])[:3]
            ctrl["pose_px_top"] = [[pxs[i], _gap(ref[i], problems[i][1]),
                                    int((prog_inl[i] != ref_inl[i]).sum())] for i in top]
    return nums, ctrl
