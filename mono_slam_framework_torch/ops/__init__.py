"""Image ops and kernel B1 (counterpart of mono_slam_framework_tpu.ops)."""
