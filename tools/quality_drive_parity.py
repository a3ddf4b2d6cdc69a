#!/usr/bin/env python3
"""The quality drive in one package at a time, and where two drives part.

    python3 tools/quality_drive_parity.py --package jax --out jax.json
    python3 tools/quality_drive_parity.py --package torch --out torch.json
    python3 tools/quality_drive_parity.py --compare jax.json torch.json

Drives `System.track_monocular` of the JAX package or of the PyTorch port
(on the CPU) over the first `--poses` poses of the quality drive (the hard
world, the rect loop at pace 0.075, two flat frames after frame 10, as
chip_smoke's reloc_loop phase drives it) at `--features` features (default
600, quality_bench's CPU size), and writes per frame its state, inliers,
keyframe insertions, map points and camera centre, and per keyframe its
frame and pose (the port on one CPU thread: its sums, and so the drive,
change with the thread count). `--compare` prints the first frame at which the two drives
differ in state, inliers, keyframe insertion or map-point count, the first
keyframe taken at another frame, and the largest keyframe-pose difference
before it. Each package runs in its own process: the JAX one imports JAX,
the port's does not.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def drive(package: str, n_poses: int, features: int) -> dict:
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from mono_slam_framework_tpu.matchers import OrbFeatureMatcher
        from mono_slam_framework_tpu.params import SlamParameters
        from mono_slam_framework_tpu.sim import RECT_LOOP_PLANES, PlaneWorld, rect_loop_trajectory
        from mono_slam_framework_tpu.slam import KeyFrameMatchDatabase, System
        from mono_slam_framework_tpu.slam.frame import reset_frame_ids
        from mono_slam_framework_tpu.slam.map_model import reset_map_ids

        extra, kw = {"prewarmShapes": False}, {}
    else:
        import torch

        torch.set_num_threads(1)  # CPU sums depend on the thread count: pin it
        from mono_slam_framework_torch.matchers import OrbFeatureMatcher
        from mono_slam_framework_torch.params import SlamParameters
        from mono_slam_framework_torch.sim import RECT_LOOP_PLANES, PlaneWorld, rect_loop_trajectory
        from mono_slam_framework_torch.slam import KeyFrameMatchDatabase, System
        from mono_slam_framework_torch.slam.frame import reset_frame_ids
        from mono_slam_framework_torch.slam.map_model import reset_map_ids

        extra, kw = {}, {"device": "cpu"}
    world = PlaneWorld(plane_z=2.0, second_plane=RECT_LOOP_PLANES, texture="smooth")
    poses = rect_loop_trajectory(3.0, 2.2, 0.075)[:n_poses]
    reset_frame_ids()
    reset_map_ids()
    params = SlamParameters(fx=world.f, fy=world.f, cx=world.cx, cy=world.cy,
                            max_features=features, minIniMatchCount=70,
                            initializerModelFallback=True, **extra)
    matcher = OrbFeatureMatcher(threshold=0.7, max_features=features, **kw)
    system = System(params, matcher, KeyFrameMatchDatabase(matcher), verbose=False, **kw)
    system.toggle_initialization_allowed()
    system.set_minimum_keyframes(0)
    frames, t, t0 = [], 0.0, time.perf_counter()
    for i, T in enumerate(poses):
        for img in [world.render(T)] + ([None] * 2 if i == 10 else []):
            n_kf = system.map.n_keyframes()
            system.track_monocular(
                np.full((world.h, world.w), 128.0, np.float32) if img is None else img, t)
            t += 0.1
            tr = system.tracker
            P = tr.current_frame.get_pose()
            frames.append({
                "pose": i, "state": tr.state.name, "inliers": int(tr.n_matches_inliers),
                "new_keyframes": system.map.n_keyframes() - n_kf,
                "map_points": system.map.n_map_points(),
                "centre": None if P is None else (-(P[:3, :3].T @ P[:3, 3])).tolist(),
            })
            if tr.state.name == "NO_IMAGES_YET":
                system.toggle_initialization_allowed()
    kfs = [{"id": kf.id, "frame": kf.frame_id, "Tcw": kf.get_pose().tolist()}
           for kf in sorted(system.map.all_keyframes(), key=lambda k: k.id)]
    return {"package": package, "poses": n_poses, "features": features,
            "seconds": time.perf_counter() - t0, "frames": frames, "keyframes": kfs}


def compare(a: dict, b: dict) -> dict:
    keys = ("state", "inliers", "new_keyframes", "map_points")
    first = next((k for k, (x, y) in enumerate(zip(a["frames"], b["frames"]))
                  if any(x[f] != y[f] for f in keys)), None)
    ka, kb = a["keyframes"], b["keyframes"]
    first_kf = next((k for k, (x, y) in enumerate(zip(ka, kb)) if x["frame"] != y["frame"]),
                    None)
    same = ka[:first_kf] if first_kf is not None else ka[:len(kb)]
    pose_diff = max((float(np.abs(np.asarray(x["Tcw"]) - np.asarray(y["Tcw"])).max())
                     for x, y in zip(same, kb)), default=None)
    return {
        "first_differing_frame": None if first is None else {
            "index": first, "pose": a["frames"][first]["pose"],
            a["package"]: {f: a["frames"][first][f] for f in keys},
            b["package"]: {f: b["frames"][first][f] for f in keys}},
        "first_differing_keyframe": None if first_kf is None else {
            "index": first_kf, a["package"]: ka[first_kf]["frame"],
            b["package"]: kb[first_kf]["frame"]},
        "keyframes_taken_at_the_same_frames": len(same),
        "max_pose_diff_of_those_keyframes": pose_diff,
        "keyframes": {a["package"]: len(ka), b["package"]: len(kb)},
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"))
    ap.add_argument("--poses", type=int, default=40)
    ap.add_argument("--features", type=int, default=600)
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        a, b = (json.loads(pathlib.Path(p).read_text()) for p in args.compare)
        print(json.dumps(compare(a, b)))
        return 0
    if not (args.package and args.out):
        ap.error("--package and --out, or --compare")
    rec = drive(args.package, args.poses, args.features)
    pathlib.Path(args.out).write_text(json.dumps(rec))
    print(json.dumps({k: rec[k] for k in ("package", "poses", "features", "seconds")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
