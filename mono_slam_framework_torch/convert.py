"""Carries state between numpy (and so the JAX package) and the port.

The ORB path has no weights; what crosses over is state: a frame's
Features, the steady step's tables, a bundle-adjustment problem and the host
map (keyframes, map points, observations, covisibility). Field names match
the JAX package's. Descriptors keep their bits: uint32 words become int32
words through `.view`, never through a value cast.

Tensors land on `device`, the card unless the caller asks for the CPU. The
map snapshot is plain Python and numpy: `snapshot_map` reads either
package's Map (they share the attribute layout) and `map_from_snapshot`
builds the port's objects, or those of any classes with the same layout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mono_slam_framework_torch import device as device_mod
from mono_slam_framework_torch.ops.orb import Features
from mono_slam_framework_torch.optim.bundle_adjust import BAProblem


def _desc_to_int32(desc) -> np.ndarray:
    desc = np.ascontiguousarray(desc)
    if desc.dtype == np.uint32:
        return desc.view(np.int32)
    if desc.dtype != np.int32:
        raise TypeError(f"descriptors must be uint32 or int32, got {desc.dtype}")
    return desc


def features_from_numpy(d, device=device_mod.DEFAULT) -> Features:
    """Dict (or NamedTuple) of arrays with the `orb.Features` fields ->
    port Features on `device`. Leading batch dims are kept."""
    device = device_mod.resolve(device)
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
    first_slot, ctx_normal, ctx_maxdist, K, device=device_mod.DEFAULT,
) -> SteadyInputs:
    """numpy steady-step state -> port tensors (f32 geometry, int32 tables)."""
    device = device_mod.resolve(device)

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


def ba_problem_from_numpy(p, device=device_mod.DEFAULT) -> BAProblem:
    """A BA problem with numpy (or array-like) fields named as
    `optim.bundle_adjust.BAProblem` — e.g. the JAX package's, padding
    included — -> the port's BAProblem on `device` (int64 indices)."""
    device = device_mod.resolve(device)
    if hasattr(p, "_asdict"):
        p = p._asdict()
    dtypes = {
        "cam_T": np.float32, "cam_fixed": np.bool_, "points": np.float32,
        "e_cam": np.int64, "e_pt": np.int64, "e_uv": np.float32,
        "e_valid": np.bool_, "e_info": np.float32, "pair_i": np.int64,
        "pair_j": np.int64, "pair_valid": np.bool_, "K": np.float32,
    }
    return BAProblem(**{
        k: torch.from_numpy(np.array(p[k], dtype=dt)).to(device)
        for k, dt in dtypes.items()
    })


# scalar attributes carried as they are (markers keep their values so that a
# restored map walks its per-pass scratch marks as the original would)
_KF_ATTRS = (
    "id", "frame_id", "timestamp", "matcher_key", "first_connection",
    "not_erase", "to_be_erased", "is_bad", "track_reference_for_frame",
    "fuse_target_for_kf", "ba_local_for_kf", "ba_fixed_for_kf",
    "ba_global_for_kf", "loop_query", "reloc_query", "reloc_score",
)
_MP_ATTRS = (
    "id", "first_kf_id", "n_obs", "distance", "n_visible", "n_found", "is_bad",
    "last_frame_seen", "track_reference_for_frame", "ba_local_for_kf",
    "fuse_candidate_for_kf", "ba_global_for_kf",
)


def _copy_arr(a):
    return None if a is None else np.array(a, np.float32)


def snapshot_map(map_) -> dict:
    """The host map as plain Python and numpy: per keyframe its pose,
    intrinsics, image, association table (pixel index -> map-point id,
    subpixel measurement, InvSigma2 weight of the detection octave, outlier
    flag), covisibility weights and spanning-tree links; per map point its
    position, normal and observations (keyframe id -> integer pixel,
    measurement, weight). Reads either package's Map."""
    kfs = sorted(map_.all_keyframes(), key=lambda kf: kf.id)
    mps = sorted(map_.all_map_points(), key=lambda mp: mp.id)
    snap_kfs = []
    for kf in kfs:
        d = {a: getattr(kf, a) for a in _KF_ATTRS}
        d.update(
            Tcw=_copy_arr(kf.Tcw), K=_copy_arr(kf.K), Tcp=_copy_arr(kf.Tcp),
            image=np.asarray(kf.image),
            cols=kf.keypoint_map.cols, rows=kf.keypoint_map.rows,
            assoc=[
                (idx, item.map_point.id, item.measurement, item.info, item.outlier)
                for idx, item in kf.keypoint_map.items()
            ],
            connections=[(k.id, w) for k, w in kf.connections.items()],
            parent=None if kf.parent is None else kf.parent.id,
            children=[c.id for c in kf.children],
        )
        snap_kfs.append(d)
    snap_mps = []
    for mp in mps:
        d = {a: getattr(mp, a) for a in _MP_ATTRS}
        d.update(
            world_pos=_copy_arr(mp.world_pos), normal=_copy_arr(mp.normal),
            ref_kf=None if mp.ref_kf is None else mp.ref_kf.id,
            observations=[
                (k.id, kp, mp.obs_measurements.get(k), mp.obs_info.get(k))
                for k, kp in mp.observations.items()
            ],
        )
        snap_mps.append(d)
    return {
        "keyframes": snap_kfs,
        "map_points": snap_mps,
        "origins": [kf.id for kf in map_.keyframe_origins],
        "max_kf_id": map_.max_kf_id,
        "big_change_idx": map_.big_change_idx,
    }


def map_from_snapshot(snap: dict, kf_db=None, classes=None):
    """Rebuild a map from `snapshot_map`'s output. Returns (map, {keyframe
    id: KeyFrame}, {map-point id: MapPoint}). Ids are kept, and the id
    counters of KeyFrame and MapPoint move past them.

    `classes` = (new_map, Frame, KeyFrame, MapPoint) with the attribute
    layout of the port's `slam/map_model.py` and `slam/frame.py`; default:
    the port's own."""
    if classes is None:
        from mono_slam_framework_torch.slam.frame import Frame
        from mono_slam_framework_torch.slam.map_model import KeyFrame, Map, MapPoint

        classes = (Map, Frame, KeyFrame, MapPoint)
    new_map, Frame, KeyFrame, MapPoint = classes
    map_ = new_map()
    kfs, mps = {}, {}
    for d in snap["keyframes"]:
        frame = Frame(d["image"], d["timestamp"], d["K"], _id=d["frame_id"])
        kf = KeyFrame(frame, map_, kf_db)
        for a in _KF_ATTRS:
            setattr(kf, a, d[a])
        if d["Tcw"] is not None:
            kf.set_pose(d["Tcw"])
        kf.Tcp = None if d["Tcp"] is None else d["Tcp"].copy()
        kfs[kf.id] = kf
        if not kf.is_bad:
            map_.add_keyframe(kf)
    for d in snap["map_points"]:
        mp = MapPoint(d["world_pos"], None, map_)
        for a in _MP_ATTRS:
            setattr(mp, a, d[a])
        mp.normal = d["normal"].copy()
        mp.ref_kf = kfs.get(d["ref_kf"])
        for kid, kp, meas, info in d["observations"]:
            kf = kfs[kid]
            mp.observations[kf] = tuple(kp)
            if meas is not None:
                mp.obs_measurements[kf] = tuple(meas)
            if info is not None:
                mp.obs_info[kf] = info
        mps[mp.id] = mp
        if not mp.is_bad:
            map_.add_map_point(mp)
    for d in snap["keyframes"]:
        kf = kfs[d["id"]]
        kf.keypoint_map.clear()
        for idx, mp_id, meas, info, outlier in d["assoc"]:
            if mp_id not in mps:
                continue
            kf.keypoint_map.set_map_point(
                kf.keypoint_map.keypoint_from_index(idx), mps[mp_id],
                measurement=meas, info=info,
            )
            kf.keypoint_map.set_outlier(idx, outlier)
        kf.connections = {kfs[k]: w for k, w in d["connections"] if k in kfs}
        kf._update_best_covisibles()
        kf.parent = kfs.get(d["parent"])
        for c in d["children"]:
            if c in kfs:
                kf.add_child(kfs[c])
    map_.keyframe_origins.extend(kfs[k] for k in snap["origins"])
    map_.max_kf_id = snap["max_kf_id"]
    map_.big_change_idx = snap["big_change_idx"]
    KeyFrame.next_id = max([KeyFrame.next_id, *(k + 1 for k in kfs)])
    MapPoint.next_id = max([MapPoint.next_id, *(m + 1 for m in mps)])
    return map_, kfs, mps
