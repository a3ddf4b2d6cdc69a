"""The frozen bounds give chip_smoke's values at PERF.md's kernel-table
shapes: B1 over the 8 levels of 640x480, B2's 2000-slot problem with 1936
valid edges (chip_smoke.pose_problem)."""

from __future__ import annotations

import pytest

from slam_bench import bounds

DIMS_640 = [(int(round(480 / 1.2**lv)), int(round(640 / 1.2**lv))) for lv in range(8)]


def test_b1_bound_at_640x480():
    ms, by = bounds.b1_bound(DIMS_640)
    assert by == "bytes" and round(ms, 4) == 0.0101


def test_b1_bound_scales_with_streams():
    assert bounds.b1_bound(DIMS_640, n_streams=4)[0] == pytest.approx(4 * bounds.b1_bound(DIMS_640)[0])


def test_b2_bound_steady_problem():
    ms, by = bounds.b2_bound(2000, 1936)
    assert by == "operations" and round(ms, 6) == 0.000225


def test_loftr_flops():
    assert bounds.loftr_encode_flops() == pytest.approx(1.13664e9, rel=1e-5)
    assert bounds.loftr_pair_flops() == pytest.approx(3.28704e8, rel=1e-5)
