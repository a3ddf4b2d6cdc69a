"""Kernel B1's share of its roofline over the traced window, in %: the
least time the card could take for every B1 launch of the window (the
frozen `bounds.b1_bound` at each launch's level sizes and stream count,
against the H100 SXM's published peaks) over the time the trace gives the
`detect_kernel` events."""

from slam_bench import bounds


def read(run):
    if run.trace is None:
        return None
    n, seconds = run.trace.kernels_matching("detect_kernel")
    launches = run.hooks.launch_b1
    if not n or not launches or n != len(launches):
        return None
    least_ms = sum(bounds.b1_bound(dims, True, streams)[0] for dims, streams in launches)
    return 100.0 * least_ms / (seconds * 1e3)
