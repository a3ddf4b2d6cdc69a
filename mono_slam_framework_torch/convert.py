"""Carries state between numpy (and so the JAX package) and the port.

The ORB path has no weights; what crosses over is state: a frame's
Features and the steady step's tables. Field names match the JAX package's
`orb.Features`. Descriptors keep their bits: uint32 words become int32
words through `.view`, never through a value cast.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mono_slam_framework_torch.ops.orb import Features


def _desc_to_int32(desc) -> np.ndarray:
    desc = np.ascontiguousarray(desc)
    if desc.dtype == np.uint32:
        return desc.view(np.int32)
    if desc.dtype != np.int32:
        raise TypeError(f"descriptors must be uint32 or int32, got {desc.dtype}")
    return desc


def features_from_numpy(d, device="cpu") -> Features:
    """Dict (or NamedTuple) of arrays with the `orb.Features` fields ->
    port Features on `device`. Leading batch dims are kept."""
    if hasattr(d, "_asdict"):
        d = d._asdict()
    arr = {k: np.asarray(v) for k, v in d.items()}

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x).astype(dtype)).to(device)

    return Features(
        xy=t(arr["xy"], np.float32),
        angle=t(arr["angle"], np.float32),
        desc=torch.from_numpy(_desc_to_int32(arr["desc"]).copy()).to(device),
        score=t(arr["score"], np.float32),
        valid=t(arr["valid"], np.bool_),
        octave=t(arr["octave"], np.int32),
    )


def features_to_numpy(f: Features) -> dict:
    """Port Features -> dict of numpy arrays; desc as uint32 words."""
    out = {k: v.detach().cpu().numpy() for k, v in f._asdict().items()}
    out["desc"] = np.ascontiguousarray(out["desc"]).view(np.uint32)
    return out


class SteadyInputs(NamedTuple):
    """The state arguments of `fused_tracking.steady_step`, in its order."""

    prev_feats: Features
    prev_px: torch.Tensor
    prev_row: torch.Tensor
    mp_pos: torch.Tensor
    T_init: torch.Tensor
    kf_feats: Features
    kf_px: torch.Tensor
    kf_row: torch.Tensor
    first_slot: torch.Tensor
    ctx_normal: torch.Tensor
    ctx_maxdist: torch.Tensor
    K: torch.Tensor


def steady_inputs_from_numpy(
    prev_feats, prev_px, prev_row, mp_pos, T_init, kf_feats, kf_px, kf_row,
    first_slot, ctx_normal, ctx_maxdist, K, device="cpu",
) -> SteadyInputs:
    """numpy steady-step state -> port tensors (f32 geometry, int32 tables)."""

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32).copy()).to(device)

    def i32(x):
        return torch.from_numpy(np.asarray(x, np.int32).copy()).to(device)

    return SteadyInputs(
        features_from_numpy(prev_feats, device),
        i32(prev_px),
        i32(prev_row),
        f32(mp_pos),
        f32(T_init),
        features_from_numpy(kf_feats, device),
        i32(kf_px),
        i32(kf_row),
        i32(first_slot),
        f32(ctx_normal),
        f32(ctx_maxdist),
        f32(K),
    )
