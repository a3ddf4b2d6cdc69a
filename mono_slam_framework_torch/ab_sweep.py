"""Matcher A/B comparison harness.

PyTorch port's counterpart of `mono_slam_framework_tpu/ab_sweep.py`. The
reference framework exists to compare feature matchers (README.md:1-2 of
the reference; SURVEY.md §0): the host app swaps FeatureMatcher
implementations and compares tracking behavior. This harness runs the same
sequence through each requested matcher and reports per-matcher tracking
statistics, timing, and (with ground truth) ATE. Every arm runs on
`--device` (default `cuda`). As in the JAX harness, `--fused` and
`--fused-one-step` apply to the ORB arm only; the other arms run the
reference-twin flow. `--sharded-loftr` adds the JAX harness's LoFTR sweep
over a device mesh (`run_sharded_loftr`).

Usage:
  python -m mono_slam_framework_torch.ab_sweep --dataset tum --path <seq> \
      --fx .. --fy .. --cx .. --cy .. [--matchers orb,loftr] [--ate] \
      [--device cuda|cpu] [--sharded-loftr]
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


def run_sharded_loftr(args) -> dict:
    """Mesh-sharded LoFTR pairwise sweep over the sequence: encode every
    frame once (the cacheable backbone), then match all consecutive pairs
    data-parallel over the device mesh (`parallel.sharded_loftr_sweep`).
    Reports per-pair match counts and throughput rather than tracking (the
    tracking A/B is `run_one`). The mesh is every visible card for
    `--device cuda`, else the one device named."""
    import numpy as np
    import torch

    from mono_slam_framework_torch import device as device_mod
    from mono_slam_framework_torch import parallel
    from mono_slam_framework_torch.io.datasets import LOADERS
    from mono_slam_framework_torch.matchers.loftr_matcher import to_model
    from mono_slam_framework_torch.models import loftr_native

    dev = device_mod.resolve(args.device)
    model = loftr_native.load_model(args.loftr_model, device=dev)
    images = []
    for frame in LOADERS[args.dataset](args.path):
        images.append(np.asarray(frame.image, np.float32))
        if args.max_frames and len(images) >= args.max_frames:
            break

    t0 = time.perf_counter()
    feats = [loftr_native.encode(model, to_model(torch.from_numpy(img).to(dev)))[0]
             for img in images]
    mesh = parallel.make_mesh() if dev == torch.device("cuda") else parallel.make_mesh(
        devices=[dev])
    n_pairs = len(feats) - 1
    ndev = mesh.size
    cap = -(-n_pairs // ndev) * ndev  # pad the batch to a mesh multiple
    f1 = torch.stack([feats[min(i, n_pairs - 1)] for i in range(cap)])
    f2 = torch.stack([feats[min(i + 1, n_pairs)] for i in range(cap)])
    vals, _ = parallel.sharded_loftr_sweep(mesh, model, f1, f2, max_matches=256)
    counts = (vals > args.loftr_threshold).sum(dim=1)[:n_pairs].cpu().numpy()
    wall = time.perf_counter() - t0
    return {
        "matcher": "loftr-sharded",
        "devices": int(ndev),
        "pairs": int(n_pairs),
        "pairs_per_s": round(n_pairs / wall, 2),
        "mean_matches": round(float(counts.mean()), 1),
        "min_matches": int(counts.min()),
    }


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
    p.add_argument(
        "--sharded-loftr",
        action="store_true",
        help="also run the mesh-sharded LoFTR pairwise sweep "
        "(parallel/sweep.py; over every card with --device cuda)",
    )
    args = p.parse_args(argv)

    if None in (args.fx, args.fy, args.cx, args.cy):
        from mono_slam_framework_torch.run import fill_calibration

        fill_calibration(args)

    results = [run_one(m.strip(), args) for m in args.matchers.split(",") if m.strip()]
    if args.sharded_loftr:
        results.append(run_sharded_loftr(args))
    print(json.dumps({"sweep": results}, indent=2))
    return results


if __name__ == "__main__":
    main()
