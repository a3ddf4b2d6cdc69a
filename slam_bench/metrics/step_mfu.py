"""The whole step's share of the card's peak over the traced window, in %:
the least time the card needs at its published peaks for the work the
window's steps did, over the window's wall time. The work counted: kernel
B1's and B2's operations (f32 peak), the Hamming distance GEMMs and the
model's products as the configuration's work file counts them (bf16
peak). It bounds every kernel's roofline share from above as long as that
kernel's work is counted here."""

from slam_bench import bounds, manifest


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    h = run.hooks
    f32 = sum(bounds.b1_ops(dims, streams) for dims, streams in h.launch_b1)
    f32 += sum(bounds.b2_ops(valid) for valid in run.b2_valid)
    bf16 = sum(bounds.hamming_ops(p, k1, k2) for p, k1, k2 in h.hamming_shapes)
    work = manifest.model_work(run.config)
    if work is not None:
        bf16 += work.flops(h)
    if not (f32 or bf16):
        return None
    least_s = f32 / bounds.PEAK_F32_FLOPS + bf16 / bounds.PEAK_BF16_FLOPS
    return 100.0 * least_s / run.trace.window_s
