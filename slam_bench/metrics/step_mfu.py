"""The whole step's share of the card's peak over the traced window, in %:
the least time the card needs at its published peaks for the work the
window's steps did, over the window's wall time. The work counted: kernel
B1's and B2's operations (f32 peak), the Hamming distance GEMMs and the
LoFTR model's products (bf16 peak). It bounds every kernel's roofline
share from above as long as that kernel's work is counted here."""

from slam_bench import bounds


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    h = run.hooks
    f32 = sum(bounds.b1_ops(dims, streams) for dims, streams in h.launch_b1)
    f32 += sum(bounds.b2_ops(valid) for valid in run.b2_valid)
    bf16 = sum(bounds.hamming_ops(p, k1, k2) for p, k1, k2 in h.hamming_shapes)
    bf16 += h.loftr_encode_images * bounds.loftr_encode_flops() + h.loftr_pairs * bounds.loftr_pair_flops()
    if not (f32 or bf16):
        return None
    least_s = f32 / bounds.PEAK_F32_FLOPS + bf16 / bounds.PEAK_BF16_FLOPS
    return 100.0 * least_s / run.trace.window_s
