#!/usr/bin/env python3
"""chip_smoke.py's System drive on any device, in any tracking flow,
optionally under torch.profiler.

    python3 tools/torch_profile_system.py [--device cuda|cpu]
        [--flow unfused|fused|pipelined|quality] [--profile N]

Runs chip_smoke.run_system at the system operating point (SYSTEM_FULL:
640x480, 2000 features, 12 warm + 30 timed frames) in the given flow
(chip_smoke.FLOWS; default unfused, fusedTracking=False) and prints its
record as one JSON line: initialization frame, states, keyframes, map
points, ATE, frames/s, latency, the stage split and, for the fused flows,
which path completed the timed frames and the fused flow's counters. On the
CPU it runs the kernels' plain versions: that drive sets chip_smoke's system
bounds. With --profile N on a card, the last N calls run under
torch.profiler and the line adds, per frame: device-busy ms, the idle
share, device ops, device->host copies, synchronizations (stream, device
and event synchronizations and blocking copies, the closing synchronize
left out) and the top device kernels; plus the path of each profiled frame.

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
import collections
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from mono_slam_framework_torch.slam import fused_host  # noqa: E402

# host-side CUDA runtime calls that wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def profile_tail(dev, cfg, world, poses, images, flow: str, k: int) -> tuple:
    """Drive all but the last k frames with run_system, then the last k
    calls under torch.profiler. Returns (run_system's record of the head,
    the per-frame device figures of the profiled calls)."""
    n = len(images) - k
    system = chip_smoke.build_system(dev, cfg, world, flow)
    head = chip_smoke.run_system(dev, cfg._replace(n_timed=n - cfg.n_warm), world,
                                 poses[:n], images[:n], system=system, flow=flow)
    pipelined = flow == "pipelined"
    step = system.track_monocular_pipelined if pipelined else system.track_monocular
    stats = fused_host.pipe_stats(system.tracker)
    if pipelined:  # run_system flushed: start the pipeline again on frame n
        step(images[n], timestamp=n * 0.1)
    paths = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for i in range(n + pipelined, len(images) + pipelined):
            before = {p: stats.get(p, 0) for p in chip_smoke.PATHS}
            if i < len(images):
                step(images[i], timestamp=i * 0.1)
            else:
                system.flush_pipeline()
            paths.append(next((p for p in chip_smoke.PATHS if stats.get(p, 0) > before[p]), None))
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t1
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:15]
    d2h = [e.name for e in kernels if "DtoH" in e.name]
    syncs = [e.name for e in events if e.name in SYNC_CALLS]
    syncs.remove("cudaDeviceSynchronize")  # the closing synchronize
    return head, {
        "frames": k, "paths": paths, "final_state": system.tracker.state.name,
        "wall_ms_per_frame": 1e3 * wall / k,
        "device_busy_ms_per_frame": busy_us / 1e3 / k,
        "idle_share": 1.0 - (busy_us / 1e6) / wall,
        "device_ops_per_frame": len(kernels) / k,
        "dtoh_copies_per_frame": len(d2h) / k,
        "synchronizations_per_frame": len(syncs) / k,
        "by_name_per_frame": {n: c / k for n, c in collections.Counter(d2h + syncs).items()},
        "top": [{"name": name[:90], "ms_per_frame": sum(v) / 1e3 / k,
                 "calls_per_frame": len(v) / k} for name, v in top],
    }


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
    ap.add_argument("--flow", default="unfused", choices=sorted(chip_smoke.FLOWS) + ["quality"])
    ap.add_argument("--profile", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=1, help="quality flow: runs in one process")
    ap.add_argument("--correction", action="store_true",
                    help="quality flow: time a loop correction on each final map")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda needs a CUDA card", file=sys.stderr)
        return 1
    if args.profile and (dev.type != "cuda" or args.flow == "quality"):
        print("--profile needs --device cuda and a System flow", file=sys.stderr)
        return 1
    rec = {"device": str(dev), "flow": args.flow}
    if dev.type == "cuda":
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        ).stdout.strip()
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
    cfg = chip_smoke.SYSTEM_FULL
    world, poses, images = chip_smoke.render_system(cfg)
    t0 = time.perf_counter()
    if not args.profile:
        run = chip_smoke.run_system(dev, cfg, world, poses, images, flow=args.flow)
    else:
        run, rec["profile"] = profile_tail(dev, cfg, world, poses, images, args.flow,
                                           args.profile)
    rec["seconds"] = time.perf_counter() - t0
    rec.update(chip_smoke.system_record(run))
    rec["states"] = run["states"]
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
