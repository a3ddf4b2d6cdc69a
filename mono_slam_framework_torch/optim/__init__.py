"""Pose optimization (counterpart of mono_slam_framework_tpu.optim).

The package exports the JAX package's names, apart from `bundle_adjust`: there
the name is the submodule, which the JAX package's re-export of the function
shadows."""

from mono_slam_framework_torch.optim.pose_opt import pose_optimize
from mono_slam_framework_torch.optim.bundle_adjust import (
    BAProblem,
    build_problem,
    global_bundle_adjust,
    local_bundle_adjust,
)

__all__ = [
    "pose_optimize",
    "BAProblem",
    "build_problem",
    "global_bundle_adjust",
    "local_bundle_adjust",
]
