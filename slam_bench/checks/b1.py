"""Kernel B1: each captured detection's five maps against the reference
maps of the same level stack, on each level's pixels at least the
detection border inside it, where the tracker reads them (`b1_gap`: the
largest difference where both are finite, over the map's largest finite
magnitude there; `b1_flips`: pixels finite in one and not the other, over
the reference's finite scores).

Wraps `detect.detect_maps` and `detect_maps_batch`: on every heavy sampled
operation it keeps each detection's level stack, sizes, threshold, border
and maps. The control runs the reference detection with TF32 products.
"""

from __future__ import annotations

import torch

from slam_bench import compare
from slam_bench.reference import detect as ref_detect

NUMBERS = ("b1_checked", "b1_gap", "b1_flips")
CONTROL_MODE = "tf32"
DETECT = "mono_slam_framework_torch.ops.detect"


def wrappers(op) -> dict:
    def make(batched: bool):
        def wrap(real):
            def wrapped(stack, dims, threshold=20.0, border=31):
                maps = real(stack, dims, threshold, border)
                if op.sampled and op.heavy:
                    s = stack if batched else stack[None]
                    m = tuple(x if batched else x[None] for x in maps)
                    op.kept.append((compare.clone(s), tuple(tuple(d) for d in dims), float(threshold),
                                    int(border), tuple(compare.clone(x) for x in m)))
                return maps
            return wrapped
        return wrap
    return {f"{DETECT}:detect_maps": make(False), f"{DETECT}:detect_maps_batch": make(True)}


def interior(dims, border: int, device) -> torch.Tensor:
    """[rows, w0] mask of each level's pixels at least `border` inside it:
    where the tracker reads the maps (keypoints lie there, and their
    31x31 moment patch and rBRIEF samples stay clear of the edge, whose
    padding the kernel and the plain version treat differently)."""
    row0, rows, w0 = ref_detect.level_layout(dims)
    m = torch.zeros(rows, w0, dtype=torch.bool, device=device)
    for (h, w), r in zip(dims, row0):
        m[r + border : r + h - border, border : w - border] = True
    return m


def _map_gaps(prog, ref, mask) -> tuple[float, float]:
    gap, flips = 0.0, 0
    for p, r in zip(prog, ref):
        p, r = p[mask], r[mask]
        fp, fr = torch.isfinite(p), torch.isfinite(r)
        flips += int((fp != fr).sum())
        both = fp & fr
        if bool(both.any()):
            scale = float(r[fr].abs().max().clamp(min=1e-30))
            gap = max(gap, float((p[both] - r[both]).abs().max()) / scale)
    n_scores = max(1, int(torch.isfinite(ref[0][mask]).sum()))
    return gap, flips / n_scores


def judge(records, config: dict, control: bool) -> tuple[dict, dict]:
    nums = {"b1_checked": 0, "b1_gap": 0.0, "b1_flips": 0.0}
    ctrl = {"b1_gap": 0.0, "b1_flips": 0.0}
    for rec in records:
        for stacks, dims, thr, border, maps in rec["kept"]:
            mask = interior(dims, border, stacks.device)
            for n in range(stacks.shape[0]):
                ref = ref_detect.detect_maps(stacks[n], dims, thr, border, "f32")
                g, f = _map_gaps([m[n] for m in maps], ref, mask)
                nums["b1_checked"] += 1
                nums["b1_gap"] = max(nums["b1_gap"], g)
                nums["b1_flips"] = max(nums["b1_flips"], f)
                if control:
                    low = ref_detect.detect_maps(stacks[n], dims, thr, border, CONTROL_MODE)
                    g, f = _map_gaps(low, ref, mask)
                    ctrl["b1_gap"] = max(ctrl["b1_gap"], g)
                    ctrl["b1_flips"] = max(ctrl["b1_flips"], f)
    return nums, (ctrl if control else {})
