"""Dataset runner: the application layer of the framework.

PyTorch port's counterpart of `mono_slam_framework_tpu/run.py`, with the
same flags, semantics and JSON summary. Replaces the reference's Webots
robot controller (src/main.cpp) as the host application: builds matcher +
database + factories, composes a System (main.cpp:78-82 wiring), drives
TrackMonocular per frame (122-128) and exports the TUM keyframe trajectory.
The reference's manual initialization gate (keyboard 'I', main.cpp:173-175)
becomes `--init-frame` (toggle after N frames; default 0 = immediately).

The matcher and the System run on `--device` (default `cuda`: the card,
kernels B1 and B2; `cpu` runs their plain versions). The JAX runner's
`--prewarm` is left out: the port compiles no shape buckets ahead, so it
has nothing to prewarm.

Usage:
  python -m mono_slam_framework_torch.run --dataset tum --path <seq_dir> \
      --matcher orb --fx 517.3 --fy 516.5 --cx 318.6 --cy 255.3 \
      --out traj.txt [--max-frames N] [--ate] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time


def build_matcher(name: str, args):
    """The named matcher on `args.device`, from the CLI's matcher flags."""
    if name == "orb":
        from mono_slam_framework_torch.matchers import OrbFeatureMatcher

        return OrbFeatureMatcher(
            threshold=args.ratio, max_features=args.features, device=args.device
        )
    if name == "loftr":
        from mono_slam_framework_torch.matchers.loftr_matcher import (
            LoftrFeatureMatcher,
        )

        return LoftrFeatureMatcher(
            model_path=args.loftr_model, threshold=args.loftr_threshold,
            device=args.device,
        )
    raise SystemExit(f"unknown matcher {name!r}")


def fill_calibration(args) -> None:
    """Fill the intrinsics not given on the command line from the sequence's
    calibration file (KITTI calib.txt, EuRoC sensor.yaml)."""
    from mono_slam_framework_torch.io.datasets import CALIB_LOADERS

    calib = CALIB_LOADERS.get(args.dataset)
    if calib is None:
        raise SystemExit(
            "--fx/--fy/--cx/--cy are required for this dataset "
            "(no calibration file convention to read them from)"
        )
    fx, fy, cx, cy = calib(args.path)
    args.fx = args.fx if args.fx is not None else fx
    args.fy = args.fy if args.fy is not None else fy
    args.cx = args.cx if args.cx is not None else cx
    args.cy = args.cy if args.cy is not None else cy


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", choices=["tum", "kitti", "euroc"], required=True)
    p.add_argument("--path", required=True, help="sequence directory")
    p.add_argument("--matcher", choices=["orb", "loftr"], default="orb")
    # Intrinsics: required for TUM; KITTI/EuRoC auto-fill from the sequence's
    # calib.txt / sensor.yaml when omitted.
    p.add_argument("--fx", type=float, default=None)
    p.add_argument("--fy", type=float, default=None)
    p.add_argument("--cx", type=float, default=None)
    p.add_argument("--cy", type=float, default=None)
    p.add_argument("--features", type=int, default=2000)
    p.add_argument("--ratio", type=float, default=0.6, help="Lowe ratio (main.cpp:66)")
    p.add_argument(
        "--min-ini-matches",
        type=int,
        default=100,
        help="min matches to attempt initialization (reference default 25 is "
        "weak without its interactive gate; 100 = upstream ORB-SLAM2)",
    )
    p.add_argument(
        "--model-fallback",
        action="store_true",
        help="retry the other H/F model when the selected one fails (QUIRKS.md)",
    )
    p.add_argument("--loftr-model", default=None,
                   help="override weights npz (default: repo checkpoint)")
    p.add_argument("--loftr-threshold", type=float, default=0.1)
    p.add_argument(
        "--gamma",
        type=float,
        default=1.0,
        help="gamma LUT applied before tracking (reference main.cpp:21-39)",
    )
    p.add_argument(
        "--fused",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="fused steady-state tracking: the per-frame OK-path as "
        "device steps with one readback each (slam/fused_host.py). Default "
        "on; --no-fused selects the strict reference-twin flow",
    )
    p.add_argument(
        "--fused-one-step",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="with --fused: both tracking phases as ONE device step with "
        "a single readback per steady frame (one-frame-stale local-KF "
        "window; fused_tracking.steady_step). Default on",
    )
    p.add_argument(
        "--pipelined",
        action="store_true",
        help="with --fused-one-step: speculative chained dispatch — device "
        "compute and readback overlap the next frame (one-frame metric "
        "latency; System.track_monocular_pipelined)",
    )
    p.add_argument(
        "--reloc-cooldown-inlier-floor",
        type=int,
        default=0,
        help="allow KF insertion during the post-reloc cooldown when inliers "
        "drop below this floor (0 = reference behavior, KNOWN_ISSUES.md)",
    )
    p.add_argument("--out", default="trajectory_tum.txt")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--init-frame", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--ate", action="store_true", help="evaluate vs groundtruth.txt")
    p.add_argument("--map-out", default="", help="save final map checkpoint (.npz)")
    p.add_argument("--device", default="cuda",
                   help="device of the matcher and the System (cuda or cpu)")
    args = p.parse_args(argv)

    from mono_slam_framework_torch.io.datasets import GROUNDTRUTH_LOADERS, LOADERS
    from mono_slam_framework_torch.params import SlamParameters
    from mono_slam_framework_torch.slam import KeyFrameMatchDatabase, System

    if None in (args.fx, args.fy, args.cx, args.cy):
        fill_calibration(args)
        if not args.quiet:
            print(f"calibration: fx={args.fx} fy={args.fy} cx={args.cx} cy={args.cy}")

    matcher = build_matcher(args.matcher, args)
    params = SlamParameters(
        fx=args.fx,
        fy=args.fy,
        cx=args.cx,
        cy=args.cy,
        max_features=args.features,
        minIniMatchCount=args.min_ini_matches,
        initializerModelFallback=args.model_fallback,
        relocCooldownInlierFloor=args.reloc_cooldown_inlier_floor,
        fusedTracking=args.fused or args.fused_one_step or args.pipelined,
        fusedOneStep=args.fused_one_step or args.pipelined,
    )
    system = System(
        params, matcher, KeyFrameMatchDatabase(matcher), verbose=not args.quiet,
        device=args.device,
    )

    gamma = None
    if args.gamma != 1.0:
        from mono_slam_framework_torch.utils import GammaCorrector

        gamma = GammaCorrector(args.gamma)

    t_start = time.perf_counter()
    n = 0
    for frame in LOADERS[args.dataset](args.path):
        if n == args.init_frame:
            system.toggle_initialization_allowed()
        image = gamma(frame.image) if gamma is not None else frame.image
        if args.pipelined:
            system.track_monocular_pipelined(image, frame.timestamp)
        else:
            system.track_monocular(image, frame.timestamp)
        n += 1
        if not args.quiet and n % 25 == 0:
            print(f"[{n}] {system.last_metrics}")
        if args.max_frames and n >= args.max_frames:
            break
    if args.pipelined:
        system.flush_pipeline()
    wall = time.perf_counter() - t_start

    system.save_keyframe_trajectory_tum(args.out)
    if args.map_out:
        system.save_checkpoint(args.map_out)
    summary = {
        "frames": n,
        "fps": round(n / wall, 2),
        "keyframes": system.map.n_keyframes(),
        "map_points": system.map.n_map_points(),
        "final_state": system.last_metrics.get("state"),
    }
    if args.ate:
        from mono_slam_framework_torch.io import trajectory

        gt_t, gt_p, _ = GROUNDTRUTH_LOADERS[args.dataset](args.path)
        t_est, p_est, _ = trajectory.read_tum(args.out)
        ate, n_assoc = trajectory.ate_rmse(t_est, p_est, gt_t, gt_p)
        summary["ate_rmse"] = round(ate, 4)
        summary["ate_pairs"] = n_assoc
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
