"""LoFTR: the motion-phase confidence [L, L] of each sampled frame (the
first single-pair confidence inside `fused_loftr.run_steady`: the current
frame against the last one) against the reference forward on the two
images the benchmark fed (`conf_gap`: the largest difference of a
confidence). The reference reads the weights file the configuration names
(`"weights"`), as the program is given it.

Wraps `fused_loftr.run_steady` (to know a steady frame) and
`loftr_native.confidence_from_features`. The control runs the reference
with fp8 operands in its products, one step below the program's bf16.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_bench import compare, manifest
from slam_bench.reference import loftr as ref_loftr

NUMBERS = ("conf_checked", "conf_gap")
CONTROL_MODE = "fp8"


def wrappers(op) -> dict:
    steady = [False]

    def run_steady(real):
        def wrapped(*a, **k):
            steady[0] = True
            try:
                return real(*a, **k)
            finally:
                steady[0] = False
        return wrapped

    def confidence(real):
        def wrapped(model, f0, f1):
            conf = real(model, f0, f1)
            if op.sampled and steady[0] and f0.shape[0] == 1 and not op.kept:
                op.kept.append(compare.clone(conf[0]))
            return conf
        return wrapped

    return {"mono_slam_framework_torch.slam.fused_loftr:run_steady": run_steady,
            "mono_slam_framework_torch.models.loftr_native:confidence_from_features": confidence}


def judge(records, config: dict, control: bool) -> tuple[dict, dict]:
    nums = {"conf_checked": 0, "conf_gap": 0.0}
    ctrl = {"conf_gap": 0.0}
    weights = None
    for rec in records:
        if not rec["kept"]:
            continue
        dev = rec["kept"][0].device
        if weights is None:
            weights = ref_loftr.load_weights(manifest.ROOT / config["weights"], dev)
        cur, prev = (torch.from_numpy(np.asarray(x, np.float32)).to(dev) for x in rec["images"])
        ref = ref_loftr.confidence(weights, cur, prev, "f32")
        nums["conf_checked"] += 1
        nums["conf_gap"] = max(nums["conf_gap"], float((rec["kept"][0] - ref).abs().max()))
        if control:
            low = ref_loftr.confidence(weights, cur, prev, CONTROL_MODE)
            ctrl["conf_gap"] = max(ctrl["conf_gap"], float((low - ref).abs().max()))
    return nums, (ctrl if control else {})
