"""The traced run's reading: device intervals from `torch.profiler`.

Method copied from `chip_smoke.py::profile_tail` (`chip_smoke.py:1654-1716`:
device events of the profiler over the window, by name), with two changes:
the device's busy time is the union of its event intervals (kernels,
copies, sets), not their sum, which counts overlapping work twice; and each
idle gap is named by the innermost host event (a benchmark span or a host
op) open on the harness's thread at the gap's middle.
"""

from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field

import numpy as np
import torch

WINDOW_SPAN = "slam_bench.window"
MAX_NAMED_GAPS = 50_000  # gaps named, longest first; the rest count as idle, unnamed
TOP = 10
WALK = 64  # host events looked at back from a gap before falling back to the spans


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_events: int
    kernel_s: dict = field(default_factory=dict)  # name -> seconds
    kernel_n: dict = field(default_factory=dict)  # name -> count
    idle_by_host: list = field(default_factory=list)  # [[name, seconds]], longest first

    def kernels_matching(self, part: str) -> tuple[int, float]:
        n = sum(c for k, c in self.kernel_n.items() if part in k)
        s = sum(t for k, t in self.kernel_s.items() if part in k)
        return n, s

    def top_device_ops(self, k: int = TOP) -> list:
        return [[name[:120], s] for name, s in
                sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:k]]


def _merge(starts: np.ndarray, ends: np.ndarray):
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    m_start = s[idx]
    m_end = np.append(run_end[idx[1:] - 1], run_end[-1]) if len(idx) else np.array([], np.int64)
    return m_start, m_end


def _innermost(hs, he, hn, candidates, mid: int, limit):
    """The name of the latest-starting event among `candidates` (indices in
    descending start order) that is still open at `mid`, looking at no more
    than `limit` of them."""
    for n, j in enumerate(candidates):
        if limit is not None and n >= limit:
            return None
        if he[j] >= mid:
            return hn[j]
    return None


def summarize(prof: torch.profiler.profile) -> TraceSummary:
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW_SPAN]
    if not win:
        raise RuntimeError("the traced window's span is missing from the trace")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    thread = win[0].start_thread_id()
    dev_s, dev_e, host_s, host_e, host_name = [], [], [], [], []
    kernel_s: dict = collections.defaultdict(float)
    kernel_n: dict = collections.defaultdict(int)
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda and not e.is_user_annotation():
            a, b = max(s, w0), min(s + d, w1)
            if b <= a:
                continue
            dev_s.append(a)
            dev_e.append(b)
            name = e.name()
            kernel_s[name] += (b - a) * 1e-9
            kernel_n[name] += 1
        elif (e.device_type() != cuda and e.start_thread_id() == thread and s + d > w0 and s < w1
              and e.name() != WINDOW_SPAN):
            host_s.append(s)
            host_e.append(s + d)
            host_name.append(e.name())
    window_s = (w1 - w0) * 1e-9
    if not dev_s:
        return TraceSummary(window_s, 0.0, 0, dict(kernel_s), dict(kernel_n), [])
    m_start, m_end = _merge(np.array(dev_s, np.int64), np.array(dev_e, np.int64))
    busy_s = float(np.sum(m_end - m_start)) * 1e-9
    g_start = np.concatenate([[w0], m_end])
    g_end = np.concatenate([m_start, [w1]])
    g_len = g_end - g_start
    keep = np.flatnonzero(g_len > 0)
    keep = keep[np.argsort(-g_len[keep], kind="stable")[:MAX_NAMED_GAPS]]
    idle = collections.defaultdict(float)
    order = np.argsort(np.array(host_s, np.int64), kind="stable")
    hs = [host_s[i] for i in order]
    he = [host_e[i] for i in order]
    hn = [host_name[i] for i in order]
    spans = [i for i, n in enumerate(hn) if n.startswith("slam_bench.")]
    span_s = [hs[i] for i in spans]
    for g in keep:
        mid = (int(g_start[g]) + int(g_end[g])) // 2
        name = _innermost(hs, he, hn, range(bisect.bisect_right(hs, mid) - 1, -1, -1), mid, WALK)
        if name is None:  # past the walk: the innermost benchmark span
            j = bisect.bisect_right(span_s, mid) - 1
            name = _innermost(hs, he, hn, (spans[i] for i in range(j, -1, -1)), mid, None)
        idle[name or "no host event"] += float(g_len[g]) * 1e-9
    ranked = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(window_s, busy_s, len(dev_s), dict(kernel_s), dict(kernel_n),
                        [[n[:120], s] for n, s in ranked])
