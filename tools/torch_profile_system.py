#!/usr/bin/env python3
"""The port's System.track_monocular drive of chip_smoke.py, on any device,
optionally under torch.profiler.

    python3 tools/torch_profile_system.py [--device cuda|cpu] [--profile N]

Runs chip_smoke.run_system at the system operating point (SYSTEM_FULL:
640x480, 2000 features, 12 warm + 30 timed frames) and prints its record as
one JSON line: initialization frame, states, keyframes, map points, ATE,
frames/s, latency and the stage split. On the CPU it runs the kernels' plain
versions: that drive sets chip_smoke's system bounds. With --profile N on a
card, the last N frames run under torch.profiler and the line adds the
device-busy ms per frame, the idle share, the device ops per frame and the
top device kernels.
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
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", type=int, default=0)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda needs a CUDA card", file=sys.stderr)
        return 1
    cfg = chip_smoke.SYSTEM_FULL
    world, poses, images = chip_smoke.render_system(cfg)
    rec = {"device": str(dev)}
    if dev.type == "cuda":
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        ).stdout.strip()
    t0 = time.perf_counter()
    if not args.profile:
        run = chip_smoke.run_system(dev, cfg, world, poses, images)
    else:
        n = len(images) - args.profile
        system = chip_smoke.build_system(dev, cfg, world)
        head = chip_smoke.run_system(dev, cfg._replace(n_timed=n - cfg.n_warm), world,
                                     poses[:n], images[:n], system=system)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for i in range(n, len(images)):
                system.track_monocular(images[i], timestamp=i * 0.1)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t1
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        by_name: dict[str, list[float]] = {}
        for e in kernels:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:15]
        k = args.profile
        run = head
        rec["profile"] = {
            "frames": k, "final_state": system.tracker.state.name,
            "wall_ms_per_frame": 1e3 * wall / k,
            "device_busy_ms_per_frame": busy_us / 1e3 / k,
            "idle_share": 1.0 - (busy_us / 1e6) / wall,
            "device_ops_per_frame": len(kernels) / k,
            "top": [{"name": name[:90], "ms_per_frame": sum(v) / 1e3 / k,
                     "calls_per_frame": len(v) / k} for name, v in top],
        }
    rec["seconds"] = time.perf_counter() - t0
    rec.update(chip_smoke.system_record(run))
    rec["states"] = run["states"]
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
