"""Utilities of the PyTorch port."""

from mono_slam_framework_torch.utils.profiling import StageTimer, trace
from mono_slam_framework_torch.utils.app import AsyncSlamDriver, GammaCorrector

__all__ = ["StageTimer", "trace", "AsyncSlamDriver", "GammaCorrector"]
