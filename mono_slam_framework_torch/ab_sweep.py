"""Matcher A/B comparison harness.

PyTorch port's counterpart of `mono_slam_framework_tpu/ab_sweep.py`. The
reference framework exists to compare feature matchers (README.md:1-2 of
the reference; SURVEY.md §0): the host app swaps FeatureMatcher
implementations and compares tracking behavior. This harness runs the same
sequence through each requested matcher and reports per-matcher tracking
statistics, timing, and (with ground truth) ATE. Every arm runs on
`--device` (default `cuda`). As in the JAX harness, `--fused` and
`--fused-one-step` apply to the ORB arm only; the other arms run the
reference-twin flow. The JAX harness's `--sharded-loftr` (a LoFTR sweep
over a device mesh) waits for the port's multi-device layer.

Usage:
  python -m mono_slam_framework_torch.ab_sweep --dataset tum --path <seq> \
      --fx .. --fy .. --cx .. --cy .. [--matchers orb,loftr] [--ate] \
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time


def run_one(matcher_name: str, args) -> dict:
    from mono_slam_framework_torch.io.datasets import GROUNDTRUTH_LOADERS, LOADERS
    from mono_slam_framework_torch.params import SlamParameters
    from mono_slam_framework_torch.run import build_matcher
    from mono_slam_framework_torch.slam import KeyFrameMatchDatabase, System

    matcher = build_matcher(matcher_name, args)
    fused = bool(args.fused or args.fused_one_step)
    params = SlamParameters(
        fx=args.fx, fy=args.fy, cx=args.cx, cy=args.cy,
        max_features=args.features,
        minIniMatchCount=args.min_ini_matches,
        initializerModelFallback=args.model_fallback,
        fusedTracking=fused and matcher_name == "orb",
        fusedOneStep=bool(args.fused_one_step) and matcher_name == "orb",
    )
    system = System(
        params, matcher, KeyFrameMatchDatabase(matcher), verbose=False,
        device=args.device,
    )

    t0 = time.perf_counter()
    n = 0
    lost = 0
    for frame in LOADERS[args.dataset](args.path):
        if n == 0:
            system.toggle_initialization_allowed()
        system.track_monocular(frame.image, frame.timestamp)
        if system.last_metrics.get("state") == "LOST":
            lost += 1
        n += 1
        if args.max_frames and n >= args.max_frames:
            break
    wall = time.perf_counter() - t0

    out_path = f"{args.out_prefix}_{matcher_name}.txt"
    system.save_keyframe_trajectory_tum(out_path)
    result = {
        "matcher": matcher_name,
        "frames": n,
        "fps": round(n / wall, 2),
        "keyframes": system.map.n_keyframes(),
        "map_points": system.map.n_map_points(),
        "lost_frames": lost,
        "final_state": system.last_metrics.get("state"),
        "stage_timing": system.timer.summary(),
        "trajectory": out_path,
    }
    if args.ate:
        from mono_slam_framework_torch.io import trajectory

        gt_t, gt_p, _ = GROUNDTRUTH_LOADERS[args.dataset](args.path)
        t_est, p_est, _ = trajectory.read_tum(out_path)
        ate, n_assoc = trajectory.ate_rmse(t_est, p_est, gt_t, gt_p)
        result["ate_rmse"] = round(ate, 4)
        result["ate_pairs"] = n_assoc
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", choices=["tum", "kitti", "euroc"], required=True)
    p.add_argument("--path", required=True)
    p.add_argument("--matchers", default="orb,loftr")
    # Intrinsics auto-fill from KITTI calib.txt / EuRoC sensor.yaml when omitted.
    p.add_argument("--fx", type=float, default=None)
    p.add_argument("--fy", type=float, default=None)
    p.add_argument("--cx", type=float, default=None)
    p.add_argument("--cy", type=float, default=None)
    p.add_argument("--features", type=int, default=2000)
    p.add_argument("--ratio", type=float, default=0.6)
    p.add_argument("--min-ini-matches", type=int, default=100)
    p.add_argument("--model-fallback", action="store_true")
    p.add_argument("--fused", action="store_true",
                   help="fused steady-state tracking for the ORB matcher")
    p.add_argument("--fused-one-step", action="store_true",
                   help="one-step steady tracking (implies --fused; ORB only)")
    p.add_argument("--loftr-model", default=None,
                   help="override weights npz (default: repo checkpoint)")
    p.add_argument("--loftr-threshold", type=float, default=0.1)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--out-prefix", default="ab_traj")
    p.add_argument("--ate", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="device of every arm's matcher and System (cuda or cpu)")
    args = p.parse_args(argv)

    if None in (args.fx, args.fy, args.cx, args.cy):
        from mono_slam_framework_torch.run import fill_calibration

        fill_calibration(args)

    results = [run_one(m.strip(), args) for m in args.matchers.split(",") if m.strip()]
    print(json.dumps({"sweep": results}, indent=2))
    return results


if __name__ == "__main__":
    main()
