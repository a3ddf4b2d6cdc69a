"""On the card (the `cuda` marker; skips here): the control of `correct`.
One cell at its own sizes over a short window: the program's numbers stay
within their limits, and the reference one precision lower, put in the
program's place, fails at least one of them. `python3 -m
slam_bench.control` reads the same over many seeds and full windows."""

from __future__ import annotations

import pytest

from slam_bench import compare, harness, manifest

BENCH = manifest.load_manifest()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["orb.sweep", "loftr.sweep"])
def test_control_fails_where_the_program_passes(cell, cuda_device):
    out = harness.run_cell(manifest.workload(BENCH, cell), 2147483999, 8.0, False, cuda_device, BENCH,
                           control=True)
    assert out.result["correct"], out.result["checks"]
    failed = [k for k, v in out.control.items() if k in out.limits and not compare.within(v, out.limits[k])]
    assert failed, out.control
