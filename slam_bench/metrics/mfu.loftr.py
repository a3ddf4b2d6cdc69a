"""The LoFTR model's share of the card's bf16 peak over the traced window,
in %: the products of every encode and every pair the window's LoFTR calls
ran, counted at each call's shapes by the configuration's work file
(`"model_work"`, `work/<name>.py`), over the window's wall time, over
989 TFLOP/s. None where the configuration names no work file or the
window made no call."""

from slam_bench import bounds, manifest


def read(run):
    work = manifest.model_work(run.config)
    if run.trace is None or work is None:
        return None
    flops = work.flops(run.hooks)
    if not flops:
        return None
    return 100.0 * flops / run.trace.window_s / bounds.PEAK_BF16_FLOPS
