"""Per-stage wall-clock timing.

PyTorch counterpart of `mono_slam_framework_tpu/utils/profiling.py`'s
StageTimer: named wall-clock accumulators around pipeline stages, named
after the reference's modules (the reference has no tracing at all,
SURVEY.md §5). Device work inside a stage is counted only as far as the
stage waits for it; the host pipeline reads every result back, so each
stage ends synchronized. For device traces use `torch.profiler`.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class StageTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "calls": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / max(self.counts[name], 1), 3),
            }
            for name in sorted(self.totals)
        }

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
