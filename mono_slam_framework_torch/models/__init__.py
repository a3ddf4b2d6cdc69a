"""The matchers' DNN models (counterpart of mono_slam_framework_tpu.models)."""
