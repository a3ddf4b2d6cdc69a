"""How `correct` is decided: the sampled answers of the window against the
plain references in `slam_bench/reference/`.

The harness samples operations of the window from the seed. On a sampled
operation the hooks of `port.py` keep, on the device, the inputs and
outputs of every pose LM (kernel B2 on a card), of the chosen detections
(kernel B1) and of the motion-phase LoFTR confidence. After the window,
with the program's state freed, this module judges them:

* tracking, kernel B2: every sampled frame that the tracker reports as
  tracked (OK, and not the frame that initialized it) must carry the pose of
  one of that operation's pose solves, bit for bit (`pose_unmatched`
  counts those that do not: an answer that never came), and that pose must
  agree with the reference LM run on the same solve's inputs (`pose_px`:
  over the frames, the largest RMS distance in pixels between the
  reference's inlier points projected by the program's pose and by the
  reference's; a pose compared entry by entry also differs along the
  directions the points barely constrain, where a 10-iteration LM stops
  short and rounding alone moves it);
* kernel B1: each captured detection's five maps against the reference
  maps of the same level stack, on each level's pixels at least the
  detection border inside it, where the tracker reads them (`b1_gap`: the
  largest difference where both are finite, over the map's largest finite
  magnitude there; `b1_flips`: pixels finite in one and not the other,
  over the reference's finite scores);
* LoFTR: the motion-phase confidence [1200, 1200] of each sampled frame
  against the reference forward on the two images the benchmark fed
  (`conf_gap`: the largest difference of a confidence);
* Hamming matching: each captured distance matrix (the first two of a
  sampled detection's operation, every 16th query row) against a popcount
  of the same descriptors (`ham_wrong`: distances that differ; exact);
* the whole System (matching, triangulation, the host replay, local
  mapping, through what they lead to): no frame left lost after
  initialization (`frames_lost`, set by the harness; exact).

`judge_ate` also reads the window's trajectory against the poses its frames
were rendered from; the harness reports it beside the result and does not
compare it: the System with TF32 switched on reads it 1.1-1.3x the
program's, so no limit separates the two.

The `*_checked` numbers count what was compared and must reach their
floor. `control=True` also reads each gap with the reference itself, one
precision lower (TF32 for the f32 geometry and detection, fp8 for LoFTR's
bf16 products), put in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_bench.reference import ate as ref_ate
from slam_bench.reference import detect as ref_detect
from slam_bench.reference import hamming as ref_hamming
from slam_bench.reference import loftr as ref_loftr
from slam_bench.reference import pose_lm as ref_pose

CHECKS = ("pose", "b1", "ham", "conf")
TRACKED_FROM = ("OK", "LOST")  # states before a frame whose pose is a tracking answer
CONTROL_MODE = {"pose": "tf32", "b1": "tf32", "conf": "fp8"}


def _pin_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _pose_problems(records, diagnose=None):
    """(inputs of the matched solve, reported pose) per tracked sampled
    frame, and the count of tracked frames no solve of their operation
    produced."""
    found, unmatched = [], 0
    for rec in records:
        host = [(args, out[0].cpu().numpy()) for args, out in rec["solves"]]
        for _, before, after, pose in rec["frames"]:
            if after != "OK" or before not in TRACKED_FROM:
                continue
            hit = next(((args, b) for args, T in host for b in range(len(T))
                        if pose is not None and np.array_equal(T[b], pose)), None)
            if hit is None:
                unmatched += 1
                continue
            args, b = hit
            found.append((tuple(None if a is None else a[b : b + 1] for a in args), pose))
            if diagnose is not None:
                out = next(o for a, o in rec["solves"] if a is args)
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


def judge_pose(records, control: bool) -> tuple[dict, dict]:
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
            low = _pose_lm_groups(problems, CONTROL_MODE["pose"])
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


def interior(dims, border: int, device) -> torch.Tensor:
    """[rows, w0] mask of each level's pixels at least `border` inside it:
    where the tracker reads the maps (keypoints lie there, and their
    31x31 moment patch and rBRIEF samples stay clear of the edge, whose
    padding the kernel and the plain version treat differently)."""
    row0, rows, w0 = ref_detect.level_layout(dims)
    m = torch.zeros(rows, w0, dtype=torch.bool, device=device)
    for (h, w), r in zip(dims, row0):
        m[r + border : r + h - border, border : w - border] = True
    return m


def _map_gaps(prog, ref, mask) -> tuple[float, float]:
    gap, flips = 0.0, 0
    for p, r in zip(prog, ref):
        p, r = p[mask], r[mask]
        fp, fr = torch.isfinite(p), torch.isfinite(r)
        flips += int((fp != fr).sum())
        both = fp & fr
        if bool(both.any()):
            scale = float(r[fr].abs().max().clamp(min=1e-30))
            gap = max(gap, float((p[both] - r[both]).abs().max()) / scale)
    n_scores = max(1, int(torch.isfinite(ref[0][mask]).sum()))
    return gap, flips / n_scores


def judge_b1(records, control: bool) -> tuple[dict, dict]:
    nums = {"b1_checked": 0, "b1_gap": 0.0, "b1_flips": 0.0}
    ctrl = {"b1_gap": 0.0, "b1_flips": 0.0}
    for rec in records:
        for stacks, dims, thr, border, maps in rec["b1"]:
            mask = interior(dims, border, stacks.device)
            for n in range(stacks.shape[0]):
                ref = ref_detect.detect_maps(stacks[n], dims, thr, border, "f32")
                g, f = _map_gaps([m[n] for m in maps], ref, mask)
                nums["b1_checked"] += 1
                nums["b1_gap"] = max(nums["b1_gap"], g)
                nums["b1_flips"] = max(nums["b1_flips"], f)
                if control:
                    low = ref_detect.detect_maps(stacks[n], dims, thr, border, CONTROL_MODE["b1"])
                    g, f = _map_gaps(low, ref, mask)
                    ctrl["b1_gap"] = max(ctrl["b1_gap"], g)
                    ctrl["b1_flips"] = max(ctrl["b1_flips"], f)
    return nums, (ctrl if control else {})


def judge_conf(records, weights: dict, control: bool) -> tuple[dict, dict]:
    nums = {"conf_checked": 0, "conf_gap": 0.0}
    ctrl = {"conf_gap": 0.0}
    for rec in records:
        if not rec["conf"] or rec.get("conf_images") is None:
            continue
        dev = rec["conf"][0].device
        cur, prev = (torch.from_numpy(np.asarray(x, np.float32)).to(dev) for x in rec["conf_images"])
        ref = ref_loftr.confidence(weights, cur, prev, "f32")
        nums["conf_checked"] += 1
        nums["conf_gap"] = max(nums["conf_gap"], float((rec["conf"][0] - ref).abs().max()))
        if control:
            low = ref_loftr.confidence(weights, cur, prev, CONTROL_MODE["conf"])
            ctrl["conf_gap"] = max(ctrl["conf_gap"], float((low - ref).abs().max()))
    return nums, (ctrl if control else {})


def judge_ham(records) -> dict:
    """Every captured Hamming matrix (its sampled query rows) against the
    popcount reference on the same descriptors: `ham_wrong` counts the
    distances that differ, an inf pattern included. Exact: both count bits."""
    nums = {"ham_checked": 0, "ham_wrong": 0}
    for rec in records:
        for d1, d2, v1, v2, d in rec["ham"]:
            ref = ref_hamming.distance_matrix(d1, d2, v1, v2)
            nums["ham_checked"] += 1
            nums["ham_wrong"] += int((d.to(ref.dtype) != ref).sum())
    return nums


def judge_ate(track) -> dict:
    """The window's tracked frames against the poses they were rendered
    from: `ate`, the RMS distance in world units between the tracked camera
    centres and the true ones after a similarity alignment (one per map:
    per stream and reset), the widest over maps."""
    maps: dict = {}
    for s, resets, pose, truth in track:
        maps.setdefault((s, resets), []).append((pose, truth))
    nums = {"ate_checked": 0, "ate": 0.0}
    for pairs in maps.values():
        if len(pairs) < 3:
            continue
        est, gt = (np.stack(c) for c in zip(*pairs))
        nums["ate_checked"] += len(pairs)
        nums["ate"] = max(nums["ate"], ref_ate.ate_rmse(est, gt))
    return nums


def judge(records, checks: list, weights: dict | None, control: bool = False) -> tuple[dict, dict]:
    """(numbers, control numbers) of the checks a cell's limits name."""
    _pin_f32()
    nums, ctrl = {}, {}
    with torch.no_grad():
        for name in checks:
            if name == "pose":
                n, c = judge_pose(records, control)
            elif name == "b1":
                n, c = judge_b1(records, control)
            elif name == "conf":
                n, c = judge_conf(records, weights, control)
            elif name == "ham":
                n, c = judge_ham(records), {}
            else:
                raise ValueError(f"unknown check {name!r}")
            nums.update(n)
            ctrl.update(c)
    return nums, ctrl


def within(value: float, limit: dict) -> bool:
    if "max" in limit:
        return value <= limit["max"]
    return value >= limit["min"]


def limit_text(limit: dict) -> str:
    return f"<= {limit['max']}" if "max" in limit else f">= {limit['min']}"
