"""Host-side visualization (numpy)."""

from mono_slam_framework_torch.viz.match_image import render_match_image
from mono_slam_framework_torch.viz.map_drawer import MapDrawer

__all__ = ["render_match_image", "MapDrawer"]
