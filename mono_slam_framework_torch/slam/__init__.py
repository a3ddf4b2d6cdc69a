"""The SLAM host pipeline and the steady tracking step (counterpart of
mono_slam_framework_tpu.slam)."""

from mono_slam_framework_torch.slam.system import System
from mono_slam_framework_torch.slam.frame import Frame, FrameBase, FrameFactory, KeyPointMap
from mono_slam_framework_torch.slam.map_model import KeyFrame, KeyFrameFactory, Map, MapPoint
from mono_slam_framework_torch.slam.kfdb import KeyFrameDatabase, KeyFrameMatchDatabase

__all__ = [
    "System",
    "Frame",
    "FrameBase",
    "FrameFactory",
    "KeyPointMap",
    "KeyFrame",
    "KeyFrameFactory",
    "Map",
    "MapPoint",
    "KeyFrameDatabase",
    "KeyFrameMatchDatabase",
]
