"""`setup_s` is read without the clock tick's grain: the process's start
keeps the tick (1/SC_CLK_TCK s), now is read to the nanosecond, so two
cells' set-up times tie only where they really do."""

from __future__ import annotations

import time

from slam_bench import harness


def test_process_age_has_no_tick_grain():
    reads = []
    for _ in range(5):
        reads.append(harness.process_age_s())
        time.sleep(0.0031)
    assert all(r > 0 for r in reads) and reads == sorted(reads)
    assert any(abs(r * 100 - round(r * 100)) > 1e-6 for r in reads), reads


def test_fallback_without_proc(monkeypatch):
    def no_proc(*a, **k):
        raise OSError("no /proc")

    monkeypatch.setattr(harness, "open", no_proc, raising=False)
    before = time.perf_counter() - harness.T_IMPORT
    age = harness.process_age_s()
    assert before <= age <= time.perf_counter() - harness.T_IMPORT
