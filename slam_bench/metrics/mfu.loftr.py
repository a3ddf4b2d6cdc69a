"""The LoFTR model's share of the card's bf16 peak over the traced window,
in %: the products of every encode and every pair the window's LoFTR calls
ran (the benchmark's counts of `loftr_native.encode` images and
`confidence_from_features` pairs, times `bounds.loftr_encode_flops` and
`bounds.loftr_pair_flops`), over the window's wall time, over 989 TFLOP/s."""

from slam_bench import bounds


def read(run):
    h = run.hooks
    if run.trace is None or not (h.loftr_encode_images or h.loftr_pairs):
        return None
    flops = h.loftr_encode_images * bounds.loftr_encode_flops() + h.loftr_pairs * bounds.loftr_pair_flops()
    return 100.0 * flops / run.trace.window_s / bounds.PEAK_BF16_FLOPS
