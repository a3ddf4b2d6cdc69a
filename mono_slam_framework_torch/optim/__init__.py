"""Pose optimization (counterpart of mono_slam_framework_tpu.optim)."""
