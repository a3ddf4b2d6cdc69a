#!/usr/bin/env python3
"""Where the time of the port's steady tracking step goes, on a CUDA card.

    python3 tools/torch_profile_steady.py [--frames 12] [--trace out.json]

Seeds the FULL map of chip_smoke.py (640x480, 2000 features, 8 local
keyframes, tables of 1024), runs 3 warm-up frames of the chained drive, then
traces --frames frames with torch.profiler. Prints one JSON line: wall ms per
frame, device-busy ms per frame (sum of kernel and memcpy time), the idle
share, the kernel-launch count per frame, and the top device kernels by time.
With --trace, the chrome trace of the window is written to that path.
"""

from __future__ import annotations

import argparse
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--trace", type=pathlib.Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = chip_smoke.FULL._replace(n_frames=3 + args.frames)
    world, poses, images = chip_smoke.render(cfg)
    seed = chip_smoke.seed_map(dev, cfg, world, poses, images)
    warm = cfg._replace(n_frames=3)
    chip_smoke.drive(dev, warm, seed, poses, images)  # builds and warms up

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chip_smoke.drive(dev, cfg._replace(n_frames=args.frames), seed, poses, images)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    if args.trace is not None:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))

    # device activity straight from the trace events: kernels and copies
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:15]
    n = args.frames
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps({
        "card": smi,
        "frames": n,
        "wall_ms_per_frame": 1e3 * wall / n,
        "device_busy_ms_per_frame": busy_us / 1e3 / n,
        "idle_share": 1.0 - (busy_us / 1e6) / wall,
        "device_ops_per_frame": len(kernels) / n,
        "top": [{"name": k[:90], "ms_per_frame": sum(v) / 1e3 / n, "calls_per_frame": len(v) / n}
                for k, v in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
