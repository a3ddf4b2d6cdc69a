"""Checks and model work that moved into files of their own read as they
did before: on a fixed seed at the CPU tests' small sizes, each cell's
check numbers equal the literals recorded from commit 76f3748, where the
checks were a fixed list in `compare.py` and the LoFTR work lived in
`bounds.py`; and the teacher's work file gives that commit's
`loftr_encode_flops()` and `loftr_pair_flops()` exactly.

The window runs under a clock that reads one second more at each call, so
it holds a fixed number of operations whatever the CPU's speed."""

from __future__ import annotations

import time

import pytest
import torch

from slam_bench import harness, manifest

from .conftest import small

BENCH = manifest.load_manifest()
SEED = 20261018

# cell -> (operations in the window, the mix's overrides, numbers at 76f3748)
RECORDED = {
    "orb.sweep": (12, {}, {
        "pose_checked": 12, "pose_unmatched": 0, "pose_px": 0.0007287221218990679,
        "b1_checked": 6, "b1_gap": 0.0, "b1_flips": 0.0, "ham_checked": 12, "ham_wrong": 0,
        "frames_lost": 0}),
    "loftr.sweep": (6, {"setup_frames": 40, "sample_every": 1}, {
        "pose_checked": 6, "pose_unmatched": 0, "pose_px": 0.0034016730521423924,
        "conf_checked": 6, "conf_gap": 1.430511474609375e-06, "frames_lost": 0}),
}


class _Ticks:
    """The harness's `time`, with a perf_counter that reads one second
    more at each call: two calls an operation."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        self.t += 1.0
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.mark.parametrize("cell", list(RECORDED))
def test_check_numbers_as_recorded(cell, monkeypatch):
    ops, traffic, numbers = RECORDED[cell]
    w = manifest.workload(BENCH, cell)
    monkeypatch.setattr(harness, "time", _Ticks())
    out = harness.run_cell(w, SEED, 2.0 * ops, False, torch.device("cpu"), BENCH,
                           overrides=small(w, **traffic))
    assert out.info["ops"] == ops
    assert out.numbers == numbers
    assert list(out.numbers) == list(numbers)
    assert out.result["correct"]


def test_teacher_work_as_recorded():
    work = manifest.model_work(manifest.load_json(manifest.config_file("loftr_tum640")))
    assert work.encode_flops(480, 640) == 1136640000.0
    assert work.pair_flops(1200) == 328704000.0
