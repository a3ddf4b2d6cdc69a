"""Plain reference of the Hamming distance matrix: the bit count of the
exclusive or of two packed 256-bit descriptors, in integers.

The semantics are the program's `ops/hamming.distance_matrix` (its
docstring: cv::DescriptorMatcher "BruteForce-Hamming"): desc1 [..., K1, 8]
and desc2 [..., K2, 8] int32 words (uint32 bits) with broadcasting leading
dimensions, valid masks beside them, and +inf for a pair with an invalid
side. The count here is a popcount, not a product, so it shares no
arithmetic with the program's bf16 matmul.
"""

from __future__ import annotations

import torch


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int32 word (the SWAR count, on int64 to keep the
    sign bit's word exact)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def distance_matrix(desc1, desc2, valid1, valid2) -> torch.Tensor:
    """[..., K1, K2] f32 Hamming distances, +inf where either side is invalid."""
    x = desc1[..., :, None, :] ^ desc2[..., None, :, :]
    d = _popcount32(x).sum(-1).to(torch.float32)
    ok = valid1[..., :, None] & valid2[..., None, :]
    return torch.where(ok, d, torch.inf)
