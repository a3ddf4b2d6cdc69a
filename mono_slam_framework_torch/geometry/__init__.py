"""SE(3) geometry (counterpart of mono_slam_framework_tpu.geometry)."""
