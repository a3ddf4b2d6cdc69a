#!/usr/bin/env python3
"""One drive in one package at a time, and where two drives part.

    python3 tools/quality_drive_parity.py --package jax --out jax.json
    python3 tools/quality_drive_parity.py --package torch --out torch.json
    python3 tools/quality_drive_parity.py --compare jax.json torch.json

    python3 tools/quality_drive_parity.py --flow loftr-init --step 0.032 --package jax --out j.json
    python3 tools/quality_drive_parity.py --flow loftr-init --step 0.032 --package torch --out t.json
    python3 tools/quality_drive_parity.py --compare j.json t.json

Drives `System.track_monocular` of the JAX package or of the PyTorch port on
the CPU. Each package runs in its own process: the JAX one imports JAX, the
port's does not. The port runs on one CPU thread: its sums, and so the drive,
change with the thread count.

`--flow quality` (default): the first `--poses` (40) poses of the quality drive
(the hard world, the rect loop at pace 0.075, two flat frames after frame 10,
as chip_smoke's reloc_loop phase drives it) at `--features` features
(default 600, quality_bench's CPU size). It writes per frame its state,
inliers, keyframe insertions, map points and camera centre, and per keyframe
its frame and pose.

`--flow loftr-init`: the LoFTR System's initialization on bench.py's serving
world (`PlaneWorld(640, 480, f=500, second_plane=(3.0, 0.3))`) over
`lateral_trajectory(--poses, step=--step)` (defaults 34 and 0.032,
bench_server's widest stream): `LoftrFeatureMatcher(threshold=0.1,
fine=False)`, `minIniMatchCount=60`, `initializerModelFallback=True`, the
fused one-step flow (the JAX package with `prewarmShapes=False`). It prints
the System's log (the reference's messages, such as "New Map created with N
points" and "Wrong initialization, reseting...") and each frame's state and
keyframe count, and writes the states and counts.

`--compare` prints the first frame at which the two drives differ (quality:
in state, inliers, keyframe insertion or map-point count; loftr-init: in
state or keyframe count), the first keyframe taken at another frame, and the
largest keyframe-pose difference before it.
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


def _api(package: str):
    """(matchers, params, sim, slam, frame, map_model modules, System
    keywords, SlamParameters keywords) of one package on the CPU."""
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from mono_slam_framework_tpu import matchers, params, sim, slam
        from mono_slam_framework_tpu.slam import frame, map_model

        return matchers, params, sim, slam, frame, map_model, {}, {"prewarmShapes": False}
    import torch

    torch.set_num_threads(1)  # CPU sums depend on the thread count: pin it
    from mono_slam_framework_torch import matchers, params, sim, slam
    from mono_slam_framework_torch.slam import frame, map_model

    return matchers, params, sim, slam, frame, map_model, {"device": "cpu"}, {}


def drive(package: str, n_poses: int, features: int) -> dict:
    matchers, params_mod, sim, slam, frame, map_model, kw, extra = _api(package)
    world = sim.PlaneWorld(plane_z=2.0, second_plane=sim.RECT_LOOP_PLANES, texture="smooth")
    poses = sim.rect_loop_trajectory(3.0, 2.2, 0.075)[:n_poses]
    frame.reset_frame_ids()
    map_model.reset_map_ids()
    params = params_mod.SlamParameters(fx=world.f, fy=world.f, cx=world.cx, cy=world.cy,
                                       max_features=features, minIniMatchCount=70,
                                       initializerModelFallback=True, **extra)
    matcher = matchers.OrbFeatureMatcher(threshold=0.7, max_features=features, **kw)
    system = slam.System(params, matcher, slam.KeyFrameMatchDatabase(matcher),
                         verbose=False, **kw)
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
    return {"flow": "quality", "package": package, "poses": n_poses, "features": features,
            "seconds": time.perf_counter() - t0, "frames": frames, "keyframes": kfs}


def drive_loftr_init(package: str, n_poses: int, step: float) -> dict:
    """The LoFTR System over bench_server's world at `step`: per frame its
    state and keyframe count, printed after the System's log of that frame."""
    matchers, params_mod, sim, slam, frame, map_model, kw, extra = _api(package)
    world = sim.PlaneWorld(width=640, height=480, f=500.0, second_plane=(3.0, 0.3))
    poses = sim.lateral_trajectory(n_poses, step=step)
    frame.reset_frame_ids()
    map_model.reset_map_ids()
    params = params_mod.SlamParameters(
        fx=world.f, fy=world.f, cx=world.cx, cy=world.cy, minIniMatchCount=60,
        initializerModelFallback=True, fusedTracking=True, fusedOneStep=True, **extra)
    matcher = matchers.LoftrFeatureMatcher(threshold=0.1, fine=False, **kw)
    system = slam.System(params, matcher, slam.KeyFrameMatchDatabase(matcher),
                         verbose=True, **kw)
    system.toggle_initialization_allowed()
    frames, t0 = [], time.perf_counter()
    for i, T in enumerate(poses):
        system.track_monocular(world.render(T), timestamp=i * 0.1)
        rec = {"pose": i, "state": system.tracker.state.name,
               "keyframes": system.map.n_keyframes()}
        print(json.dumps(rec), flush=True)
        frames.append(rec)
    kfs = [{"id": kf.id, "frame": kf.frame_id, "Tcw": kf.get_pose().tolist()}
           for kf in sorted(system.map.all_keyframes(), key=lambda k: k.id)]
    return {"flow": "loftr-init", "package": package, "poses": n_poses,
            "step": step, "seconds": time.perf_counter() - t0, "frames": frames,
            "keyframes": kfs}


FRAME_KEYS = {"quality": ("state", "inliers", "new_keyframes", "map_points"),
              "loftr-init": ("state", "keyframes")}


def compare(a: dict, b: dict) -> dict:
    if a["flow"] != b["flow"]:
        raise ValueError("the two records are of different flows")
    keys = FRAME_KEYS[a["flow"]]
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
    ap.add_argument("--flow", choices=tuple(FRAME_KEYS), default="quality")
    ap.add_argument("--package", choices=("jax", "torch"))
    ap.add_argument("--poses", type=int, help="poses driven (default: quality 40, loftr-init 34)")
    ap.add_argument("--features", type=int, default=600)
    ap.add_argument("--step", type=float, default=0.032, help="loftr-init: lateral step")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        a, b = (json.loads(pathlib.Path(p).read_text()) for p in args.compare)
        print(json.dumps(compare(a, b)))
        return 0
    if not (args.package and args.out):
        ap.error("--package and --out, or --compare")
    if args.flow == "loftr-init":
        rec = drive_loftr_init(args.package, args.poses or 34, args.step)
        head = ("flow", "package", "poses", "step", "seconds")
    else:
        rec = drive(args.package, args.poses or 40, args.features)
        head = ("flow", "package", "poses", "features", "seconds")
    pathlib.Path(args.out).write_text(json.dumps(rec))
    print(json.dumps({k: rec[k] for k in head}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
