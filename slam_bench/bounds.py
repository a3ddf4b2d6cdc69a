"""The yardstick: peaks of the card and the work of the kernels. A model's
work is its own file, `work/<name>.py`, named by the configuration.

Frozen copies, so that an edit of the program or of `chip_smoke.py` cannot
move them:

* `bound_ms`, `b1_bound`, `b2_bound` and their operation counts:
  `chip_smoke.py:866-912` (B1_OPS_PER_PIXEL, B2_OPS_PER_EDGE_PASS,
  B2_EDGE_PASSES, PEAK_F32_FLOPS, PEAK_BYTES_PER_S, `bound_ms`, `b1_bound`,
  `b2_bound`), with `detect.level_layout` (`ops/detect.py:69-76`) copied
  as `level_layout`;
* the bf16 peak: NVIDIA's H100 SXM data sheet, dense (989 TFLOP/s), beside
  the f32 and bandwidth peaks of the same sheet.

Every peak is the published one, at the card's full 700 W; a run reports
the card's power limit beside the shares.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# B1 per level pixel (chip_smoke.py:866-871): FAST 64, Sobel 24, gradient
# products 3, 7x7 box over 3 products 84, Harris 6, 3x3 NMS 9, moments 248,
# 7x7 Gaussian 28.
B1_OPS_PER_PIXEL = 64 + 24 + 3 + 84 + 6 + 9 + 248 + 28
# B2 per edge and pass (chip_smoke.py:872-876): transform 15, projection 8,
# residual and chi2 6, Huber 4, Jacobian 36, J^T W J 84, J^T W r 24; 4
# rounds x (1 + 10 trial) passes.
B2_OPS_PER_EDGE_PASS = 15 + 8 + 6 + 4 + 36 + 84 + 24
B2_EDGE_PASSES = 4 * 11


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float = PEAK_F32_FLOPS):
    """(least ms the card could take, what bounds it)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def level_layout(dims):
    row0, r = [], 0
    for h, _ in dims:
        row0.append(r)
        r += h
    return tuple(row0), r, max(w for _, w in dims)


def b1_ops(dims, n_streams: int = 1) -> float:
    return B1_OPS_PER_PIXEL * n_streams * sum(h * w for h, w in dims)


def b1_bound(dims, stacked: bool = True, n_streams: int = 1):
    """One stacked launch reads the [rows, w0] stack and writes 5 maps of
    it (per stream); one-level launches read and write each level."""
    px = n_streams * sum(h * w for h, w in dims)
    _, rows, w0 = level_layout(tuple(dims))
    n_bytes = 4 * 6 * (n_streams * rows * w0 if stacked else px)
    return bound_ms(n_bytes, B1_OPS_PER_PIXEL * px)


def b2_ops(n_valid: int) -> float:
    return B2_OPS_PER_EDGE_PASS * B2_EDGE_PASSES * n_valid


def b2_bound(n_slots: int, n_valid: int, n_problems: int = 1):
    """Inputs Xw, uv, info (6 f32 per slot), valid (1 byte), T_init, K;
    outputs T, one inlier byte per slot, n_good; operations count the valid
    edges' passes (n_valid of all problems together)."""
    n_bytes = n_problems * (25 * n_slots + 4 * (16 + 9) + n_slots + 4 * (16 + 1))
    return bound_ms(n_bytes, b2_ops(n_valid))


def hamming_ops(n_pairs: int, k1: int, k2: int, bits: int = 256) -> float:
    """The distance GEMM of `ops/hamming.py` ([K1, 256] x [256, K2] per set
    pair, bf16 operands): 2 operations per product term."""
    return 2.0 * n_pairs * k1 * k2 * bits
