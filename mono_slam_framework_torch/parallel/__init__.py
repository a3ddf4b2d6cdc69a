"""Serving N camera streams on one card (counterpart of
mono_slam_framework_tpu.parallel's single-device serving mode)."""

from mono_slam_framework_torch.parallel.multistream import (
    extract_batch,
    steady_step_batch,
    steady_step_loftr_batch,
)
from mono_slam_framework_torch.parallel.server import SlamServer

__all__ = [
    "SlamServer",
    "extract_batch",
    "steady_step_batch",
    "steady_step_loftr_batch",
]
