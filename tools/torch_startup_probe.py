#!/usr/bin/env python3
"""The cold cost of a fresh process's first essential-graph solve, and of the
autodiff Jacobian it replaced.

    python3 tools/torch_startup_probe.py            # every case, each in a fresh process
    python3 tools/torch_startup_probe.py --case C   # one case in this process

Each case starts in a fresh process, on the card, at the surgical loop's
graph size (7 nodes, 16 edges; `slam/device_io.graph_problem` moved off its
optimum), and times between synchronizes:

  analytic — the solve (`optim/pose_graph.optimize_pose_graph`) first: its
             first Jacobian, first linalg.solve and the rest
             (chip_smoke.graph_breakdown), then a second solve;
  jacfwd   — first the graph's Jacobian by `torch.func.jacfwd` of its
             residuals (how the solver took it before), then the largest
             difference from the analytic Jacobian at the same point.

Each reports whether the process has imported `torch._dynamo` and its live
objects (what every full garbage collection walks). Prints one JSON line per
case and the card's name and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = ("analytic", "jacfwd")


def _timed(fn, sync):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def run_case(case: str) -> dict:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from mono_slam_framework_torch.geometry import se3
    from mono_slam_framework_torch.optim import pose_graph
    from mono_slam_framework_torch.slam import device_io

    dev = torch.device("cuda", 0)
    sync = lambda: torch.cuda.synchronize(dev)  # noqa: E731
    _, ctx_ms = _timed(lambda: torch.zeros(1, device=dev), sync)
    rec = {"case": case, "cuda_context_ms": ctx_ms}
    T, fixed, e_i, e_j, T_meas, w = (t.to(dev) for t in device_io.graph_problem(7, 16))
    T = se3.exp_se3(torch.full((7, 6), 0.01, device=dev)) @ T  # off the optimum
    args = (T, fixed, e_i, e_j, T_meas, w)
    if case == "analytic":
        with chip_smoke.graph_breakdown(sync) as parts:
            pose_graph.optimize_pose_graph(*args)
        rec["graph"] = dict(parts)
        _, rec["second_graph_ms"] = _timed(lambda: pose_graph.optimize_pose_graph(*args), sync)
    else:
        T_meas_inv, w_sqrt = se3.inverse(T_meas), torch.sqrt(w)

        def res(xi):
            Tn = se3.compose(se3.exp_se3(xi.reshape(7, 6)), T)
            return pose_graph._edge_residuals(Tn, e_i, e_j, T_meas_inv, w_sqrt).reshape(-1)

        J, rec["first_jacfwd_ms"] = _timed(
            lambda: torch.func.jacfwd(res)(torch.zeros(42, device=dev)), sync)
        _, J_i, J_j = pose_graph._edge_jacobians(T, e_i, e_j, T_meas_inv, w_sqrt)
        at_i = torch.nn.functional.one_hot(e_i, 7).float()[:, None, :, None]
        at_j = torch.nn.functional.one_hot(e_j, 7).float()[:, None, :, None]
        analytic = (J_i[:, :, None, :] * at_i + J_j[:, :, None, :] * at_j).reshape(-1, 42)
        rec["max_abs_diff_to_analytic"] = float((J - analytic).abs().max())
    rec["dynamo_imported"] = "torch._dynamo" in sys.modules
    rec["live_objects"] = len(gc.get_objects())
    rec["card"] = chip_smoke.card(dev)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=CASES)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_startup_probe: needs a CUDA card", file=sys.stderr)
        return 1
    if args.case:
        print(json.dumps(run_case(args.case)), flush=True)
        return 0
    for case in CASES:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, __file__, "--case", case], capture_output=True,
                             text=True, timeout=300)
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
            return out.returncode
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        rec["process_s"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
