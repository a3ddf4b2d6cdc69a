"""Serving and scaling beyond one stream (counterpart of
mono_slam_framework_tpu.parallel): N camera streams on one card
(`SlamServer`, `multistream`), and the multi-device layer over a mesh
driven from one process (`mesh`, `sweep`, the sharded steady steps,
`ba_sharded`, `loftr_tp`)."""

from mono_slam_framework_torch.parallel.ba_sharded import (
    global_bundle_adjust_sharded,
    make_ba_mesh,
)
from mono_slam_framework_torch.parallel.loftr_tp import loftr_tp_confidence
from mono_slam_framework_torch.parallel.mesh import Mesh
from mono_slam_framework_torch.parallel.multistream import (
    extract_batch,
    steady_step_batch,
    steady_step_batch_sharded,
    steady_step_loftr_batch,
    steady_step_loftr_batch_sharded,
)
from mono_slam_framework_torch.parallel.server import SlamServer
from mono_slam_framework_torch.parallel.sweep import (
    make_mesh,
    sharded_loftr_sweep,
    sharded_matcher_sweep,
    sharded_tracking_step,
)

__all__ = [
    "global_bundle_adjust_sharded",
    "make_ba_mesh",
    "loftr_tp_confidence",
    "SlamServer",
    "make_mesh",
    "sharded_loftr_sweep",
    "sharded_matcher_sweep",
    "sharded_tracking_step",
    "Mesh",
    "extract_batch",
    "steady_step_batch",
    "steady_step_batch_sharded",
    "steady_step_loftr_batch",
    "steady_step_loftr_batch_sharded",
]
