#!/usr/bin/env python3
"""Launch kernels B1 and B2 on every visible card, from a given checkout.

    python3 tools/torch_launch_cards.py [--root CHECKOUT]

For each kernel, one subprocess imports the port from CHECKOUT (default: this
repository), launches the kernel on cuda:0 and then on each other card, and
holds each launch against the plain version on that card (B1: the score map's
largest difference where both are finite; B2: the pose's). Each other card is
tried twice, in two subprocesses: as the wrapper launches ("as launched") and
inside `torch.cuda.device(card)` ("card current"). Prints one JSON line per
kernel and mode; an error is printed in place of its number. Run it on
another checkout (an older commit unpacked with `git archive`) to see how that
commit's launches behave on a card that is not the first.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

CASE = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from mono_slam_framework_torch.ops import detect, orb
from mono_slam_framework_torch.optim import pose_opt, pose_opt_cuda

kernel, current = sys.argv[2], sys.argv[3] == "card current"
img, prob = cs.loftr_pair()[0], cs.pose_problem()


def launch(d):
    if kernel == "b1":
        stack = orb.pyramid(torch.from_numpy(img).to(d))
        dims = orb._level_dims(*img.shape)
        got = detect.detect_maps_cuda(stack, dims, cs.FAST_THRESHOLD, orb.BORDER)
        ref = detect.detect_maps_plain(stack, dims, cs.FAST_THRESHOLD, orb.BORDER)
        torch.cuda.synchronize(d)
        fin = torch.isfinite(ref.score) & torch.isfinite(got.score)
        return float((got.score[fin] - ref.score[fin]).abs().max())
    t = [torch.from_numpy(a).to(d) for a in prob]
    got = pose_opt_cuda.pose_optimize_cuda(*t)
    ref = pose_opt.pose_optimize_plain(*t)
    torch.cuda.synchronize(d)
    return float((got[0] - ref[0]).abs().max())


out = {"kernel": kernel, "mode": sys.argv[3], "root": sys.argv[1]}
for i in range(torch.cuda.device_count()):
    d = torch.device("cuda", i)
    try:
        if current and i:
            with torch.cuda.device(d):
                out[str(d)] = launch(d)
        else:
            out[str(d)] = launch(d)
    except Exception as e:  # report the failure of this card and go on
        out[str(d)] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
print(json.dumps(out), flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=pathlib.Path, default=ROOT)
    args = ap.parse_args()
    root = str(args.root.resolve())
    for kernel in ("b1", "b2"):
        for mode in ("as launched", "card current"):
            proc = subprocess.run([sys.executable, "-c", CASE, root, kernel, mode],
                                  capture_output=True, text=True, timeout=300)
            print(proc.stdout.strip() or json.dumps(
                {"kernel": kernel, "mode": mode, "error": proc.stderr[-800:]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
