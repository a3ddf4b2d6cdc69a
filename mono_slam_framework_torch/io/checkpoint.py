"""Full-map checkpoint / resume.

The reference can only export a trajectory (System::SaveKeyFrameTrajectoryTUM,
System.cc:89-122) — no map serialization, no resume (SURVEY.md §5). This
module adds a complete map snapshot: keyframe poses + images (needed because
the MatchFrames contract re-matches raw images), map points, observations and
the spanning tree, stored as one compressed .npz.

PyTorch-port copy of `mono_slam_framework_tpu/io/checkpoint.py` over the
port's map classes. The .npz layout is the JAX package's, so a file written
by either package loads in the other. `load_map` reads each array of the
file once (the JAX copy indexes the NpzFile per row, which decompresses the
array again on every access), and keys the map's keyframe registry by the
restored ids: the registry is what the native observation graph's answers
are read through, and the JAX copy leaves it keyed by the ids the
keyframes had before they were overwritten.
"""

from __future__ import annotations

import numpy as np

from mono_slam_framework_torch.slam.map_model import KeyFrame, MapPoint


def save_map(path: str, map_) -> None:
    kfs = sorted([kf for kf in map_.all_keyframes() if not kf.is_bad], key=lambda k: k.id)
    mps = sorted([mp for mp in map_.all_map_points() if not mp.is_bad], key=lambda m: m.id)
    mp_by_obj = {mp: i for i, mp in enumerate(mps)}

    obs = []  # (mp_row, kf_id, x, y)
    obs_meas = []  # (fx, fy) matching obs rows
    obs_info = []  # InvSigma2 weight matching obs rows
    for i, mp in enumerate(mps):
        for kf, kp in mp.observations.items():
            if not kf.is_bad:
                obs.append((i, kf.id, kp[0], kp[1]))
                m = mp.measurement_in_keyframe(kf)
                obs_meas.append((float(m[0]), float(m[1])))
                obs_info.append(mp.info_in_keyframe(kf))

    outliers = []  # (kf_row, index) — per-KF outlier flags
    for r, kf in enumerate(kfs):
        for idx, item in kf.keypoint_map.items():
            if item.outlier:
                outliers.append((r, idx))

    np.savez_compressed(
        path,
        kf_ids=np.array([kf.id for kf in kfs], np.int64),
        kf_frame_ids=np.array([kf.frame_id for kf in kfs], np.int64),
        kf_timestamps=np.array([kf.timestamp for kf in kfs], np.float64),
        kf_poses=np.stack([kf.Tcw for kf in kfs]) if kfs else np.zeros((0, 4, 4)),
        kf_images=np.stack(
            [np.asarray(kf.image).astype(np.uint8) for kf in kfs]
        )
        if kfs
        else np.zeros((0, 0, 0), np.uint8),
        kf_K=kfs[0].K if kfs else np.eye(3, dtype=np.float32),
        kf_parents=np.array(
            [kf.parent.id if kf.parent is not None else -1 for kf in kfs], np.int64
        ),
        origin_ids=np.array([kf.id for kf in map_.keyframe_origins], np.int64),
        mp_ids=np.array([mp.id for mp in mps], np.int64),
        mp_pos=np.stack([mp.world_pos for mp in mps]) if mps else np.zeros((0, 3)),
        mp_normal=np.stack([mp.normal for mp in mps]) if mps else np.zeros((0, 3)),
        mp_distance=np.array([mp.distance for mp in mps], np.float32),
        mp_found=np.array([mp.n_found for mp in mps], np.int64),
        mp_visible=np.array([mp.n_visible for mp in mps], np.int64),
        mp_first_kf=np.array([mp.first_kf_id for mp in mps], np.int64),
        mp_ref_kf=np.array(
            [mp.ref_kf.id if mp.ref_kf is not None else -1 for mp in mps], np.int64
        ),
        observations=np.array(obs, np.int64) if obs else np.zeros((0, 4), np.int64),
        obs_measurements=np.array(obs_meas, np.float64)
        if obs_meas
        else np.zeros((0, 2), np.float64),
        obs_infos=np.array(obs_info, np.float32)
        if obs_info
        else np.zeros((0,), np.float32),
        outliers=np.array(outliers, np.int64) if outliers else np.zeros((0, 2), np.int64),
    )


def load_map(path: str, map_, kf_db, params) -> None:
    """Rebuild the live map model from a snapshot (clears existing state)."""
    from mono_slam_framework_torch.slam.frame import Frame

    # every array read once: indexing an NpzFile decompresses the array again
    # on each access, which the per-point loops below would pay per row
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    map_.clear()
    if kf_db is not None:
        kf_db.clear()

    K = data["kf_K"]
    kf_by_id: dict[int, KeyFrame] = {}
    for r in range(len(data["kf_ids"])):
        frame = Frame(
            data["kf_images"][r].astype(np.float32),
            float(data["kf_timestamps"][r]),
            K,
            _id=int(data["kf_frame_ids"][r]),
        )
        frame.set_pose(data["kf_poses"][r].astype(np.float32))
        kf = KeyFrame(frame, map_, kf_db)
        kf.id = int(data["kf_ids"][r])  # preserve original ids
        kf.first_connection = False
        kf_by_id[kf.id] = kf
        map_.add_keyframe(kf)
        if kf_db is not None:
            kf_db.add(kf)
    KeyFrame.next_id = max(kf_by_id, default=-1) + 1
    map_.kf_registry.clear()
    map_.kf_registry.update(kf_by_id)

    mps: list[MapPoint] = []
    for r in range(len(data["mp_ids"])):
        mp = MapPoint(data["mp_pos"][r], None, map_)
        mp.id = int(data["mp_ids"][r])
        mp.normal = data["mp_normal"][r].astype(np.float32)
        mp.distance = float(data["mp_distance"][r])
        mp.n_found = int(data["mp_found"][r])
        mp.n_visible = int(data["mp_visible"][r])
        mp.first_kf_id = int(data["mp_first_kf"][r])
        ref_id = int(data["mp_ref_kf"][r])
        mp.ref_kf = kf_by_id.get(ref_id)
        mps.append(mp)
        map_.add_map_point(mp)
    MapPoint.next_id = max((mp.id for mp in mps), default=-1) + 1

    obs_meas = data.get("obs_measurements")
    obs_infos = data.get("obs_infos")
    for r, (mp_row, kf_id, x, y) in enumerate(data["observations"]):
        mp = mps[mp_row]
        kf = kf_by_id[int(kf_id)]
        m = tuple(obs_meas[r]) if obs_meas is not None and len(obs_meas) else None
        w = float(obs_infos[r]) if obs_infos is not None and len(obs_infos) else 1.0
        mp.add_observation(kf, (int(x), int(y)), measurement=m, info=w)
        kf.keypoint_map.set_map_point((int(x), int(y)), mp, measurement=m, info=w)

    for kf in sorted(kf_by_id.values(), key=lambda k: k.id):
        kf.update_connections()
    for r, kf_id in enumerate(data["kf_ids"]):
        pid = int(data["kf_parents"][r])
        if pid >= 0 and pid in kf_by_id:
            kf_by_id[int(kf_id)].parent = kf_by_id[pid]
            kf_by_id[pid].add_child(kf_by_id[int(kf_id)])
    map_.keyframe_origins.extend(
        kf_by_id[int(i)] for i in data["origin_ids"] if int(i) in kf_by_id
    )
    kfs_sorted = sorted(kf_by_id.values(), key=lambda k: k.id)
    for r, idx in data["outliers"]:
        kfs_sorted[int(r)].keypoint_map.set_outlier(int(idx), True)
