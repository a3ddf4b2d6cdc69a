"""Operand rounding for the references' products.

A reference runs its products in f32 (`"f32"`: operands as they are). The
control of a comparison runs the same reference one precision lower, as a
later change might: `"tf32"` rounds each f32 operand to TF32's 10-bit
mantissa (round to nearest even), which is what a TF32 tensor-core product
does to its inputs before it accumulates in f32; `"fp8"` rounds each
operand to float8 e4m3 under a per-tensor scale (amax to 448), as a scaled
fp8 product does. Both are emulated in f32 arithmetic, so they give the
same numbers on any device.
"""

from __future__ import annotations

import torch

MODES = ("f32", "tf32", "fp8")
FP8_MAX = 448.0


def round_operand(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "f32":
        return x
    x = x.float()
    if mode == "tf32":
        bits = x.contiguous().view(torch.int32)
        lsb = (bits >> 13) & 1
        bits = (bits + 0x0FFF + lsb) & ~0x1FFF
        return bits.view(torch.float32)
    if mode == "fp8":
        scale = torch.clamp(x.abs().amax() / FP8_MAX, min=1e-30)
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {mode!r}; one of {MODES}")


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    return torch.matmul(round_operand(a, mode), round_operand(b, mode))
