"""Brute-force Hamming matching as a matmul.

PyTorch counterpart of `mono_slam_framework_tpu/ops/hamming.py`
(cv::DescriptorMatcher "BruteForce-Hamming" knnMatch(k=2) + Lowe ratio
test). hamming(a, b) = |a| + |b| - 2 a.b for 0/1 bit vectors, so the whole
distance matrix is one matmul. Its operands are bf16, as the JAX package's
are: 0 and 1 are exact in bf16, and so is every count of 0/1 products up to
256 (bf16 holds each integer to 2^8), even where the library rounds the
product to bf16. The distances are read as f32 and equal the f32 product's.
"""

from __future__ import annotations

import torch

N_BITS = 256


def unpack_bits(packed, dtype=torch.float32):
    """int32 [..., 8] (uint32 bits) -> [..., 256] of {0,1} in `dtype`. The
    arithmetic shift of a negative word still leaves the right bit 31."""
    shifts = torch.arange(32, device=packed.device, dtype=packed.dtype)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], N_BITS).to(dtype)


def distance_matrix(desc1, desc2, valid1, valid2):
    """Pairwise Hamming distances; invalid pairs are +inf.

    desc1 [..., K1, 8], desc2 [..., K2, 8] with broadcasting leading dims
    (one set against a batch of sets [B, K2, 8] gives [B, K1, K2]; N streams'
    sets [N, K1, 8] against [N, K2, 8] give [N, K1, K2]); valid masks match.
    """
    b1 = unpack_bits(desc1, torch.bfloat16)
    b2 = unpack_bits(desc2, torch.bfloat16)
    n1 = b1.sum(-1, dtype=torch.float32)
    n2 = b2.sum(-1, dtype=torch.float32)
    dot = (b1 @ b2.transpose(-1, -2)).to(torch.float32)
    d = n1[..., :, None] + n2[..., None, :] - 2.0 * dot
    ok = valid1[..., :, None] & valid2[..., None, :]
    return torch.where(ok, d, torch.inf)


def knn2_ratio_match(d, ratio: float):
    """Per-row 2-NN with the Lowe ratio test (strict '<').

    Args:
      d: [..., K1, K2] distance matrix (+inf for invalid pairs).
      ratio: accept when best < ratio * second-best.

    Returns:
      (idx2 int64 [..., K1], ok bool [..., K1]) — the first best train index
      per query (ties: lowest index) and whether the ratio test passed.
    """
    idx = torch.argmin(d, dim=-1)
    best = torch.gather(d, -1, idx[..., None])[..., 0]
    d2 = d.scatter(-1, idx[..., None], torch.inf)
    second = d2.amin(dim=-1)
    ok = torch.isfinite(best) & (best < ratio * second)
    return idx, ok
