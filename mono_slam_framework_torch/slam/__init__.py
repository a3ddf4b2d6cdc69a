"""Steady-state tracking (counterpart of mono_slam_framework_tpu.slam)."""
