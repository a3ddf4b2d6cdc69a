"""Hamming matching: each captured distance matrix (the first two of a
heavy sampled operation, every 16th query row) against a popcount of the
same descriptors (`ham_wrong`: distances that differ, an inf pattern
included; exact, since both count bits). No control: an exact comparison
has the limit 0.

Wraps `hamming.distance_matrix`.
"""

from __future__ import annotations

from slam_bench import compare
from slam_bench.reference import hamming as ref_hamming

NUMBERS = ("ham_checked", "ham_wrong")
# the Hamming answers kept on a heavy sampled operation: its first
# HAM_CALLS matrices, every 16th query row of each
HAM_CALLS = 2
HAM_ROWS = slice(None, None, 16)


def wrappers(op) -> dict:
    def wrap(real):
        def wrapped(desc1, desc2, valid1, valid2):
            d = real(desc1, desc2, valid1, valid2)
            if op.sampled and op.heavy and len(op.kept) < HAM_CALLS:
                op.kept.append((compare.clone(desc1[..., HAM_ROWS, :]), compare.clone(desc2),
                                compare.clone(valid1[..., HAM_ROWS]), compare.clone(valid2),
                                compare.clone(d[..., HAM_ROWS, :])))
            return d
        return wrapped
    return {"mono_slam_framework_torch.ops.hamming:distance_matrix": wrap}


def judge(records, config: dict, control: bool) -> tuple[dict, dict]:
    nums = {"ham_checked": 0, "ham_wrong": 0}
    for rec in records:
        for d1, d2, v1, v2, d in rec["kept"]:
            ref = ref_hamming.distance_matrix(d1, d2, v1, v2)
            nums["ham_checked"] += 1
            nums["ham_wrong"] += int((d.to(ref.dtype) != ref).sum())
    return nums, {}
