"""Share of the traced window's wall time that no device interval covers:
100 (1 - union of the device intervals / window), in %."""


def read(run):
    if run.trace is None or not run.trace.device_events:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
