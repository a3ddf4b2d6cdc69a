"""Device operations (kernels, copies, sets) in the traced window per
frame of the window."""


def read(run):
    if run.trace is None or not run.trace.device_events or not run.frames:
        return None
    return run.trace.device_events / run.frames
