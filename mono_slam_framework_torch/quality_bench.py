"""Tracking-quality bench: ATE + loop-closure quality on the hard world.

PyTorch port's counterpart of `mono_slam_framework_tpu/quality_bench.py`.
Run as `python -m mono_slam_framework_torch.quality_bench [--device cuda|cpu]`;
prints ONE cumulative JSON line after each arm. The drives run on `device`
(default `cuda`) with 2000 ORB features there and 600 on the CPU, the
choice the JAX bench makes by backend. Its background warm
(`prewarmShapes`) keeps the port's default, off, where the JAX bench turns
it on for its accelerator. The JAX bench's XLA compile-cache reclaim has no
counterpart here: the port compiles nothing per shape.

The scenario is the off-lattice "hard world" of tests/test_hard_world.py
minus the sensor-dropout leg: a rectangular lawnmower loop whose return
strip shares no view with the outbound strip (a genuine loop — image match
without covisibility, LoopClosing.cc:69-99), smooth texture so corners sit
off the 8 px lattice. Reported:

  * ate_rmse_hardworld  — final full-trajectory scale-aligned ATE RMSE
    (io/trajectory.ate_rmse vs ground truth; north star = BASELINE.md
    trajectory-fidelity row)
  * ate_loop_before/after — ATE immediately before/after the loop
    CorrectLoop fires (the loop global BA's measured drift removal,
    LoopClosing.cc:101-115)
  * with both_arms, ate_loop_before/after_fork — the reference fork's
    GBA-only correction measured on the same map state (`run_fork_twin`).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

# Rect-loop trajectory step (world units/frame; optical flow ~250*step px
# at the z~2 planes), the JAX bench's: 0.075 keeps tracking alive and
# yields the genuine loop there.
QUALITY_STEP = float(os.environ.get("QUALITY_STEP", "0.075"))


def _hard_world():
    from mono_slam_framework_torch.sim import (
        RECT_LOOP_PLANES,
        PlaneWorld,
        rect_loop_trajectory,
    )

    world = PlaneWorld(
        plane_z=2.0, second_plane=RECT_LOOP_PLANES, texture="smooth"
    )
    return world, rect_loop_trajectory(3.0, 2.2, QUALITY_STEP)


def _frame_ate(system, gt_t, gt_p):
    """Scale-aligned ATE of the per-frame trajectory export, None under 10
    associated frames."""
    import numpy as np

    from mono_slam_framework_torch.io import trajectory

    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "fr.txt")
        system.save_trajectory_tum(p)
        t_fr, p_fr, _ = trajectory.read_tum(p)
    if len(t_fr) < 3:
        return None
    a, n = trajectory.ate_rmse(t_fr, p_fr, np.array(gt_t), np.stack(gt_p))
    return float(a) if n >= 10 else None


def run_fork_twin(system, ate_now) -> float | None:
    """Measure the reference fork's GBA-only CorrectLoop
    (LoopClosing.cc:101-115, loopFuseDuplicates=False twin) on the SAME
    map state the default arm is about to correct, then restore it: the
    poses and positions, and the global BA's staged markers (Tcw_gba,
    Tcw_bef_gba and ba_global_for_kf of every keyframe, pos_gba and
    ba_global_for_kf of every point). The twin's GBA runs under the loop
    keyframe id the default arm's correction then uses, so markers it left
    behind would make that correction skip keyframes it must re-anchor
    (the JAX bench restores only poses and positions). Returns the ATE
    `ate_now()` reads after the twin's correction."""
    lc = system.loop_closer
    snap_kf = [
        (kf, kf.get_pose().copy(), kf.Tcw_gba, kf.Tcw_bef_gba, kf.ba_global_for_kf)
        for kf in system.map.all_keyframes()
        if not kf.is_bad
    ]
    snap_mp = [
        (mp, mp.world_pos.copy(), mp.pos_gba, mp.ba_global_for_kf)
        for mp in system.map.all_map_points()
        if not mp.is_bad
    ]
    saved_fuse, saved_lm = lc.fuse_duplicates, lc.local_mapper
    lc.fuse_duplicates = False  # fork GBA schedule (10 iters)
    lc.local_mapper = None  # release() would drop queued KFs
    try:
        lc.current_kf.update_connections()
        lc.run_global_bundle_adjustment(lc.current_kf.id)
        after = ate_now()
    finally:
        lc.fuse_duplicates, lc.local_mapper = saved_fuse, saved_lm
        for kf, T, T_gba, T_bef, marker in snap_kf:
            kf.set_pose(T)
            kf.Tcw_gba, kf.Tcw_bef_gba, kf.ba_global_for_kf = T_gba, T_bef, marker
        for mp, X, X_gba, marker in snap_mp:
            mp.set_world_pos(X)
            mp.pos_gba, mp.ba_global_for_kf = X_gba, marker
    return after


def run_quality(
    n_poses: int | None = None,
    fuse_duplicates: bool | None = None,
    device="cuda",
    dropout_at: int | None = None,
    both_arms: bool = False,
):
    import numpy as np

    from mono_slam_framework_torch import device as device_mod
    from mono_slam_framework_torch.matchers import OrbFeatureMatcher
    from mono_slam_framework_torch.params import SlamParameters
    from mono_slam_framework_torch.slam import KeyFrameMatchDatabase, System
    from mono_slam_framework_torch.slam.frame import reset_frame_ids
    from mono_slam_framework_torch.slam.map_model import reset_map_ids
    from mono_slam_framework_torch.slam.tracking import TrackingState

    dev = device_mod.resolve(device)
    world, poses = _hard_world()
    if n_poses is not None:
        poses = poses[:n_poses]

    # 2000 features — the north-star operating point, where the JAX bench's
    # chip runs found the third corner survives; 600 on the CPU
    maxf = 600 if dev.type == "cpu" else 2000
    reset_frame_ids()
    reset_map_ids()
    params = SlamParameters(
        fx=world.f, fy=world.f, cx=world.cx, cy=world.cy,
        max_features=maxf, minIniMatchCount=70,
        initializerModelFallback=True,
        # SlamParameters is a frozen dataclass: the override must ride the
        # constructor (None = the params.py default)
        **(
            {}
            if fuse_duplicates is None
            else {"loopFuseDuplicates": fuse_duplicates}
        ),
    )
    matcher = OrbFeatureMatcher(threshold=0.7, max_features=maxf, device=dev)
    system = System(
        params, matcher, KeyFrameMatchDatabase(matcher), verbose=False, device=dev
    )
    system.toggle_initialization_allowed()
    system.set_minimum_keyframes(0)

    gt_t, gt_p = [], []

    def ate_now():
        return _frame_ate(system, gt_t, gt_p)

    # spy the loop correction to measure ATE immediately before/after
    orig_correct = system.loop_closer.correct_loop
    loop_events: list = []
    fork_events: list = []
    fork_errors: list = []
    frame_counter = [0]

    def spy_correct():
        before = ate_now()
        if both_arms and system.loop_closer.fuse_duplicates:
            # a failed twin must not stop the default arm's correction; it
            # is reported as quality_error_fork
            try:
                fork_events.append((before, run_fork_twin(system, ate_now)))
            except Exception as e:
                fork_events.append((before, None))
                fork_errors.append(repr(e)[:200])
        orig_correct()
        loop_events.append(
            (
                before,
                ate_now(),
                frame_counter[0],
                system.loop_closer.last_fuse_count,
            )
        )

    system.loop_closer.correct_loop = spy_correct

    t = 0.0
    n_ok = 0
    for i, T in enumerate(poses):
        frame_counter[0] = i
        system.track_monocular(world.render(T), t)
        gt_t.append(t)
        gt_p.append(-(T[:3, :3].T @ T[:3, 3]))
        t += 0.1
        if system.tracker.state == TrackingState.NO_IMAGES_YET:
            system.toggle_initialization_allowed()
        if system.tracker.state == TrackingState.OK:
            n_ok += 1
        if dropout_at is not None and i == dropout_at:
            # sensor-dropout leg (tests/test_hard_world.py): two flat frames
            # force LOST -> relocalization
            for _ in range(2):
                system.track_monocular(
                    np.full((world.h, world.w), 128.0, np.float32), t
                )
                t += 0.1

    before = after = frame_idx = fused = None
    if loop_events:
        before, after, frame_idx, fused = loop_events[-1]
    rnd = lambda x: None if x is None else round(x, 4)
    out = {
        "ate_rmse_hardworld": rnd(ate_now()),
        "ate_loop_before": rnd(before),
        "ate_loop_after": rnd(after),
        "loop_detected": bool(system.loop_closer.last_loop_kf_id > 0),
        "loop_frame_idx": frame_idx,
        "loop_fused": fused,
        "quality_frames_ok_share": round(n_ok / max(len(poses), 1), 3),
    }
    if both_arms and fork_events:
        fb, fa = fork_events[-1]
        out["ate_loop_before_fork"] = rnd(fb)
        out["ate_loop_after_fork"] = rnd(fa)
    if fork_errors:
        out["quality_error_fork"] = fork_errors[-1]
    return out


def run_quality_loftr(n_poses: int | None = None, device="cuda"):
    """LoFTR matcher quality row: the framework exists to compare feature
    matchers (README.md:1-2, FeatureMatcher.h:41-47), so the bench tracks
    BOTH plugins' tracking quality. Same hard world and rect-loop trajectory
    as the ORB arms, DNN matcher at the reference app's configuration
    (threshold 0.1, src/main.cpp:63). Default pose budget is smaller than
    ORB's: the transformer forward dominates, and the row's purpose is an
    ATE-quality comparison, not loop coverage."""
    from mono_slam_framework_torch import device as device_mod
    from mono_slam_framework_torch.matchers.loftr_matcher import LoftrFeatureMatcher
    from mono_slam_framework_torch.params import SlamParameters
    from mono_slam_framework_torch.slam import KeyFrameMatchDatabase, System
    from mono_slam_framework_torch.slam.frame import reset_frame_ids
    from mono_slam_framework_torch.slam.map_model import reset_map_ids
    from mono_slam_framework_torch.slam.tracking import TrackingState

    dev = device_mod.resolve(device)
    world, poses = _hard_world()
    if n_poses is None:
        n_poses = int(os.environ.get("QUALITY_LOFTR_POSES", "40"))
    poses = poses[:n_poses]

    reset_frame_ids()
    reset_map_ids()
    params = SlamParameters(
        fx=world.f, fy=world.f, cx=world.cx, cy=world.cy,
        minIniMatchCount=40, initializerModelFallback=True,
    )
    matcher = LoftrFeatureMatcher(threshold=0.1, fine=False, device=dev)
    system = System(
        params, matcher, KeyFrameMatchDatabase(matcher), verbose=False, device=dev
    )
    system.toggle_initialization_allowed()
    system.set_minimum_keyframes(0)

    gt_t, gt_p = [], []
    t = 0.0
    n_ok = 0
    for i, T in enumerate(poses):
        system.track_monocular(world.render(T), t)
        gt_t.append(t)
        gt_p.append(-(T[:3, :3].T @ T[:3, 3]))
        t += 0.1
        if system.tracker.state == TrackingState.NO_IMAGES_YET:
            system.toggle_initialization_allowed()
        if system.tracker.state == TrackingState.OK:
            n_ok += 1

    ate = _frame_ate(system, gt_t, gt_p)
    return {
        "ate_rmse_hardworld_loftr": None if ate is None else round(ate, 4),
        "quality_loftr_frames_ok_share": round(n_ok / max(len(poses), 1), 3),
        "quality_loftr_poses": len(poses),
    }


def main(argv=None) -> None:
    """Emit a CUMULATIVE JSON line after each quality arm so a deadline kill
    preserves every completed arm. Arms, in priority order:
      1. shipped defaults (loopFuseDuplicates=True) with the reference-fork
         twin measured off the SAME trajectory at the loop event
         (both_arms): ate_rmse_hardworld + ate_loop_before/after next to
         ate_loop_*_fork;
      2. LoFTR matcher row: ate_rmse_hardworld_loftr.
    A wall-clock deadline (QUALITY_DEADLINE_S, default 1200 s) is checked
    between arms; arms that would start past it are skipped."""
    import time

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="device of both arms' matcher and System (cuda or cpu)")
    args = p.parse_args(argv)

    t0 = time.monotonic()
    deadline = float(os.environ.get("QUALITY_DEADLINE_S", "1200"))
    n_poses = os.environ.get("QUALITY_POSES")
    n_poses = int(n_poses) if n_poses else None

    out: dict = {}

    def emit():
        print(json.dumps(out), flush=True)

    arms = [
        (None, lambda: run_quality(n_poses=n_poses, device=args.device, both_arms=True)),
        ("_loftr", lambda: run_quality_loftr(device=args.device)),
    ]
    for suffix, fn in arms:
        if time.monotonic() - t0 > deadline:
            out.setdefault("quality_skipped_arms", []).append(suffix or "default")
            continue
        try:
            fields = fn()
        except Exception as e:
            out[f"quality_error{suffix or ''}"] = repr(e)[:200]
            emit()
            continue
        out.update(fields)
        emit()
    if "quality_skipped_arms" in out:
        emit()


if __name__ == "__main__":
    main()
