#!/usr/bin/env python3
"""chip_smoke.py's System drive on any device, in any tracking flow,
optionally under torch.profiler.

    python3 tools/torch_profile_system.py [--device cuda|cpu]
        [--flow unfused|fused|pipelined|quality|quality_loftr] [--matcher orb|loftr]
        [--loftr-f32] [--profile N]

Runs chip_smoke.run_system at the system operating point (SYSTEM_FULL:
640x480, 2000 features, 12 warm + 30 timed frames; with `--matcher loftr`
chip_smoke's LoFTR System, SYSTEM_LOFTR) in the given flow
(chip_smoke.FLOWS; default unfused, fusedTracking=False) and prints its
record as one JSON line: initialization frame, states, keyframes, map
points, ATE, frames/s, latency, the stage split and, for the fused flows,
which path completed the timed frames and the fused flow's counters. On the
CPU it runs the kernels' plain versions: that drive sets chip_smoke's system
bounds. With --profile N on a card, the last N calls run under
torch.profiler and the line adds, per frame: device-busy ms, the idle
share, device ops, device->host copies, synchronizations (stream, device
and event synchronizations and blocking copies, the closing synchronize
left out) and the top device kernels; plus the path of each profiled frame
(chip_smoke.profile_tail).

`--flow quality_loftr` runs chip_smoke.run_quality_loftr (the LoFTR
quality drive: the smooth rect-loop world at 320x240, 40 poses) and prints
its record; `--loftr-f32` runs the LoFTR model's products in f32 on the
card as well (chip_smoke.loftr_f32), for comparison with its bf16 path.

`--flow quality` runs chip_smoke's reloc_loop drive instead
(chip_smoke.run_loop_drive at LOOP_FULL: the JAX package's quality drive,
320x240, 2000 features, 141 poses of the rect loop with two flat frames
after frame 10) and prints its record: states, relocalization attempts,
the loop and its ATE before and after, the correction's steps in ms.
`--repeat N` drives it N times in one process and adds each run's keyframe
pose checksum (the sum of |Tcw| over the keyframes): equal checksums mean
the runs built the same map. `--correction` then times a loop correction's
steps at the drive's size on each run's final map (`correction_cost`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import chip_smoke  # noqa: E402

def correction_cost(system, dev, reps: int = 2) -> list:
    """The steps of a loop correction at the size of `system`'s map, timed on
    `dev`: LoopClosing._prealign_loop with the newest keyframe revisiting the
    first (the newest keyframe's points against copies shifted by
    chip_smoke.SURGICAL_DRIFT: a Sim(3) fit, then the essential graph over
    every keyframe), then the loop GBA (25 LM x 200 PCG iterations, staged
    under a loop id no keyframe has). `reps` rounds; the first pays the
    process's start-up. The map is changed by the pre-alignment."""
    from mono_slam_framework_torch.slam import loop_closing
    from mono_slam_framework_torch.slam.map_model import MapPoint

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    lc = system.loop_closer
    kfs = sorted((kf for kf in system.map.all_keyframes() if not kf.is_bad), key=lambda k: k.id)
    lc.current_kf, lc.matched_kf = kfs[-1], kfs[0]
    shift = np.asarray(chip_smoke.SURGICAL_DRIFT, np.float32)
    olds = [it.map_point for _, it in kfs[-1].map_point_items()
            if it.map_point is not None and not it.map_point.is_bad]
    pairs = [(MapPoint(mp.world_pos + shift, kfs[-1], None), mp) for mp in olds]
    graph_ms = []
    real_graph = loop_closing.optimize_pose_graph_np

    def timed_graph(*a, **k):
        t0 = time.perf_counter()
        out = real_graph(*a, **k)
        sync()
        graph_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    out = []
    loop_closing.optimize_pose_graph_np = timed_graph
    try:
        for _ in range(reps):
            t0 = time.perf_counter()
            ok = lc._prealign_loop(pairs)
            sync()
            t1 = time.perf_counter()
            loop_closing.run_global_ba(system.map, 25, dev, robust=False,
                                       loop_kf=system.map.max_kf_id + 1, cg_iters=200)
            sync()
            out.append({"keyframes": len(kfs), "pairs": len(pairs), "prealigned": ok,
                        "prealign": lc.last_prealign,
                        "prealign_ms": (t1 - t0) * 1e3,
                        "graph_ms": graph_ms[-1] if ok else None,
                        "gba_ms": (time.perf_counter() - t1) * 1e3})
    finally:
        loop_closing.optimize_pose_graph_np = real_graph
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--flow", default="unfused",
                    choices=sorted(chip_smoke.FLOWS) + ["quality", "quality_loftr"])
    ap.add_argument("--loftr-f32", action="store_true",
                    help="the LoFTR model's products in f32 on the card too")
    ap.add_argument("--matcher", default="orb", choices=("orb", "loftr"))
    ap.add_argument("--profile", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=1, help="quality flow: runs in one process")
    ap.add_argument("--correction", action="store_true",
                    help="quality flow: time a loop correction on each final map")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda needs a CUDA card", file=sys.stderr)
        return 1
    if args.profile and (dev.type != "cuda" or args.flow.startswith("quality")):
        print("--profile needs --device cuda and a System flow", file=sys.stderr)
        return 1
    rec = {"device": str(dev), "flow": args.flow}
    if dev.type == "cuda":
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        ).stdout.strip()
    precision = chip_smoke.loftr_f32() if args.loftr_f32 else contextlib.nullcontext()
    rec["loftr_products"] = "f32" if args.loftr_f32 or dev.type != "cuda" else "bf16"
    if args.flow == "quality_loftr":
        with precision:
            rec.update(chip_smoke.run_quality_loftr(dev))
        print(json.dumps(rec), flush=True)
        return 0
    if args.flow == "quality":
        world, poses, images = chip_smoke.render_loop(chip_smoke.LOOP_FULL)
        for i in range(args.repeat):
            run = chip_smoke.run_loop_drive(dev, chip_smoke.LOOP_FULL, world, poses, images)
            system = run.pop("system")
            kfs = sorted(system.map.all_keyframes(), key=lambda kf: kf.id)
            checksum = float(sum(abs(kf.get_pose().astype("float64")).sum() for kf in kfs))
            if args.correction:
                run["correction_cost"] = correction_cost(system, dev)
            print(json.dumps({**rec, "run": i, "pose_checksum": checksum, **run}), flush=True)
        return 0
    cfg = chip_smoke.SYSTEM_LOFTR if args.matcher == "loftr" else chip_smoke.SYSTEM_FULL
    world, poses, images = chip_smoke.render_system(cfg)
    rec["matcher"] = args.matcher
    t0 = time.perf_counter()
    with precision:
        if not args.profile:
            system = chip_smoke.build_system(dev, cfg, world, args.flow, args.matcher)
            run = chip_smoke.run_system(dev, cfg, world, poses, images, system=system,
                                        flow=args.flow)
        else:
            run, rec["profile"] = chip_smoke.profile_tail(
                dev, cfg, world, poses, images, args.flow, args.profile, args.matcher)
    rec["seconds"] = time.perf_counter() - t0
    rec.update(chip_smoke.system_record(run))
    rec["states"] = run["states"]
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
