"""Per-stage wall-clock timing.

PyTorch counterpart of `mono_slam_framework_tpu/utils/profiling.py`'s
StageTimer: named wall-clock accumulators around pipeline stages, named
after the reference's modules (the reference has no tracing at all,
SURVEY.md §5). Device work inside a stage is counted only as far as the
stage waits for it; the host pipeline reads every result back, so each
stage ends synchronized. `trace` writes a `torch.profiler` device trace.
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


@contextlib.contextmanager
def trace(log_dir: str):
    """Profiler trace around a code block: CPU and, where there is a card,
    CUDA activity, written to `log_dir` as a Chrome trace that TensorBoard's
    profiler plugin also reads (the JAX package's jax.profiler trace)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield
