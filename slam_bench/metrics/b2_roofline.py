"""Kernel B2's share of its roofline over the traced window, in %: the
least time the card could take for every B2 launch of the window (the
frozen `bounds.b2_bound` at each launch's edge slots, valid edges and
problems, the valid edges counted from the launch's inputs after the
window) over the time the trace gives the `pose_lm_kernel` events."""

from slam_bench import bounds


def read(run):
    if run.trace is None:
        return None
    n, seconds = run.trace.kernels_matching("pose_lm_kernel")
    launches = run.hooks.launch_b2
    if not n or not launches or n != len(launches):
        return None
    least_ms = sum(bounds.b2_bound(e, valid, b)[0]
                   for (e, b, _), valid in zip(launches, run.b2_valid))
    return 100.0 * least_ms / (seconds * 1e3)
