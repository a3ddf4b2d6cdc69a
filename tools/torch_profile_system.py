#!/usr/bin/env python3
"""chip_smoke.py's System drive on any device, in any tracking flow,
optionally under torch.profiler.

    python3 tools/torch_profile_system.py [--device cuda|cpu]
        [--flow unfused|fused|pipelined] [--profile N]

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--flow", default="unfused", choices=sorted(chip_smoke.FLOWS))
    ap.add_argument("--profile", type=int, default=0)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda needs a CUDA card", file=sys.stderr)
        return 1
    if args.profile and dev.type != "cuda":
        print("--profile needs --device cuda", file=sys.stderr)
        return 1
    cfg = chip_smoke.SYSTEM_FULL
    world, poses, images = chip_smoke.render_system(cfg)
    rec = {"device": str(dev), "flow": args.flow}
    if dev.type == "cuda":
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        ).stdout.strip()
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
