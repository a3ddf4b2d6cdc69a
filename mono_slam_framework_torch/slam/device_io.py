"""Host <-> device bridge: gather map state into arrays, run the optimizers
on the device, scatter results back into the host map model.

PyTorch counterpart of `mono_slam_framework_tpu/slam/device_io.py`, the
replacement for the reference's Optimizer.cc g2o glue:
  * optimize_frame_pose  <->  Optimizer::PoseOptimization (217-334); on a
                              CUDA device it launches kernel B2
  * run_local_ba         <->  Optimizer::LocalBundleAdjustment (336-574)
  * run_global_ba        <->  Optimizer::BundleAdjustment / GlobalBundleAdjustemnt
                              (62-215) incl. the staged nLoopKF != 0 mode

Every function takes the device to run on. Arrays have the problem's own
sizes: the JAX package's pow2 padding and capacity ladders exist for its
compile cache and are not ported. Of its background warm, the start-up warm
of the essential graph is (`prewarm_startup_shapes`); the warms of its
ladder rungs have no counterpart, since eager PyTorch compiles nothing per
shape.
"""

from __future__ import annotations

import numpy as np
import torch

from mono_slam_framework_torch.geometry import se3
from mono_slam_framework_torch.optim import bundle_adjust as ba
from mono_slam_framework_torch.optim import pose_opt
from mono_slam_framework_torch.utils.prewarm import Build, Spec, prewarm

# above this camera count the full-map BA switches from the dense Schur
# solve to matrix-free PCG (O(E) per CG application, no O(sum deg^2) pair
# list)
GLOBAL_BA_DENSE_MAX_CAMS = 24

# (nodes, edges) of the essential-graph warms (the JAX package's rungs)
GRAPH_WARM_SIZES = ((16, 128), (64, 512))


def _to(device, a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


def prewarm_startup_shapes(device) -> None:
    """Background-warm the first loop correction's essential graph at System
    construction, at the sizes the JAX package warms it ((16, 128) and (64,
    512) nodes and edges): the loop event is once per run, so a cold first
    solve would stall the correction right when quality is measured.
    Asynchronous, and a no-op on the CPU (utils/prewarm.py). The JAX
    package's start-up warms of local BA, the triangulation sweep and
    batched matching are left out: they fill its compile cache, and the
    port measured no first-use cost in its first keyframe events."""
    from mono_slam_framework_torch.optim.pose_graph import optimize_pose_graph

    for N, E in GRAPH_WARM_SIZES:
        prewarm(optimize_pose_graph, *(Build(Spec(tuple(t.shape), t.dtype, device), t.to)
                                       for t in graph_problem(N, E)))


def graph_problem(N: int, E: int) -> tuple:
    """optimize_pose_graph's arguments for a warm, on the CPU: N
    near-identity poses (node k rotated by k x (0.01, -0.02, 0.005) rad and
    moved by k x (-0.1, 0.01, 0) m), node 0 fixed, and E edges (the chain,
    then skips of 2, 3, ...), each measured as T_i T_j^-1 of the poses it
    joins, weight 1."""
    T = se3.exp_se3(torch.arange(N, dtype=torch.float32)[:, None]
                    * torch.tensor([0.01, -0.02, 0.005, -0.1, 0.01, 0.0]))
    e = torch.arange(E)
    e_i = e % (N - 1)
    e_j = torch.clamp(e_i + 1 + (e // (N - 1)) % (N - 1), max=N - 1)
    return (T, torch.arange(N) == 0, e_i, e_j, T[e_i] @ se3.inverse(T[e_j]),
            torch.ones(E))


def optimize_frame_pose(frame, device) -> int:
    """Motion-only pose refinement of `frame` against its associated map
    points; writes the pose and per-pixel outlier flags back.

    Returns the inlier count (the reference returns
    nInitialCorrespondences - nBad, Optimizer.cc:333; it returns 0 and skips
    when fewer than 3 correspondences, Optimizer.cc:285).
    """
    entries = [
        (idx, item)
        for idx, item in frame.keypoint_map.items()
        if item.map_point is not None
    ]
    n = len(entries)
    if n < 3:
        return 0
    Xw = np.stack([item.map_point.world_pos for _, item in entries])
    uv = np.asarray([frame.keypoint_map.measurement_at(idx) for idx, _ in entries])
    info = np.asarray([item.info for _, item in entries])
    T_opt, inlier, n_good = pose_opt.pose_optimize(
        _to(device, frame.Tcw, np.float32),
        _to(device, Xw, np.float32),
        _to(device, uv, np.float32),
        torch.ones(n, dtype=torch.bool, device=device),
        _to(device, frame.K, np.float32),
        _to(device, info, np.float32),
    )
    frame.set_pose(T_opt.cpu().numpy())
    for (_, item), ok in zip(entries, inlier.cpu().numpy()):
        item.outlier = not bool(ok)
    return int(n_good)


def _collect_ba_window(local_mps: list, current_marker):
    """Fixed-camera discovery: keyframes that observe a local point but are
    not in the local window."""
    fixed_kfs = []
    for mp in local_mps:
        for kf in mp.observations:
            if (
                kf.ba_local_for_kf != current_marker
                and kf.ba_fixed_for_kf != current_marker
            ):
                kf.ba_fixed_for_kf = current_marker
                if not kf.is_bad:
                    fixed_kfs.append(kf)
    return fixed_kfs


def run_local_ba(current_kf, map_, device) -> None:
    """Local BA over the covisible window (Optimizer.cc:336-574)."""
    marker = current_kf.id
    local_kfs = [current_kf]
    current_kf.ba_local_for_kf = marker
    for kf in current_kf.get_covisibles():
        kf.ba_local_for_kf = marker
        if not kf.is_bad:
            local_kfs.append(kf)

    local_mps = []
    for kf in local_kfs:
        for _, item in kf.map_point_items():
            mp = item.map_point
            if mp is not None and not mp.is_bad and mp.ba_local_for_kf != marker:
                local_mps.append(mp)
                mp.ba_local_for_kf = marker

    fixed_kfs = _collect_ba_window(local_mps, marker)

    cams = local_kfs + fixed_kfs
    cam_index = {kf: i for i, kf in enumerate(cams)}
    origin_id = map_.origin_kf_id()
    cam_fixed = np.array(
        [kf.id == origin_id for kf in local_kfs] + [True] * len(fixed_kfs),
        bool,
    )
    # Gauge anchoring: with no outside observers a monocular BA window has a
    # free scale gauge and every solve slides the map scale. Anchor by fixing
    # the two oldest window keyframes (as the JAX package does).
    if not fixed_kfs and cam_fixed.sum() < 2:
        oldest = np.argsort([kf.id for kf in local_kfs])[:2]
        cam_fixed[oldest] = True
    mp_index = {mp: i for i, mp in enumerate(local_mps)}

    e_cam, e_pt, e_uv, e_ref, e_info = [], [], [], [], []
    for mp in local_mps:
        for kf in mp.observations:
            if kf.is_bad or kf not in cam_index:
                continue
            e_cam.append(cam_index[kf])
            e_pt.append(mp_index[mp])
            e_uv.append(mp.measurement_in_keyframe(kf))
            e_info.append(mp.info_in_keyframe(kf))
            e_ref.append((kf, mp))
    if not e_cam:
        return

    p = ba.build_problem(
        np.stack([kf.Tcw for kf in cams]),
        cam_fixed,
        np.stack([mp.world_pos for mp in local_mps]),
        e_cam, e_pt, e_uv, cams[0].K, e_info=e_info, device=device,
    )
    T_out, X_out, bad, _ = ba.local_bundle_adjust(p)
    T_out, X_out, bad = (t.cpu().numpy() for t in (T_out, X_out, bad))

    # erase bad observations (Optimizer.cc:526-549)
    for (kf, mp), flagged in zip(e_ref, bad):
        if flagged:
            kf.erase_map_point_match(mp)
            mp.erase_observation(kf)

    # write back optimized local cameras and landmarks (550-573)
    for i, kf in enumerate(local_kfs):
        if not cam_fixed[i]:
            kf.set_pose(T_out[i])
    for mp, i in mp_index.items():
        if not mp.is_bad:
            mp.set_world_pos(X_out[i])
            mp.update_normal_and_depth()


def global_ba_mesh(device):
    """The mesh the global BA shards its edges over, or None for one device:
    every visible card when `device` is a card and there is more than one
    (the JAX package's `len(jax.devices()) > 1`)."""
    if torch.device(device).type != "cuda" or torch.cuda.device_count() < 2:
        return None
    from mono_slam_framework_torch import parallel

    return parallel.make_ba_mesh()


def run_global_ba(
    map_, n_iters: int, device, robust: bool = True, loop_kf: int = 0,
    cg_iters: int = 60,
) -> None:
    """Full-map BA (Optimizer::BundleAdjustment, 71-215): dense Schur up to
    GLOBAL_BA_DENSE_MAX_CAMS cameras, matrix-free PCG above, edge-sharded
    over `global_ba_mesh(device)` when that gives a mesh.

    loop_kf == 0 applies results directly; otherwise results are staged in
    kf.Tcw_gba / mp.pos_gba like the reference (186-213).
    """
    kfs = [kf for kf in map_.all_keyframes() if not kf.is_bad]
    mps = [mp for mp in map_.all_map_points() if not mp.is_bad]
    if not kfs or not mps:
        return
    kfs.sort(key=lambda kf: kf.id)
    cam_index = {kf: i for i, kf in enumerate(kfs)}
    origin_id = map_.origin_kf_id()
    cam_fixed = np.array([kf.id == origin_id for kf in kfs], bool)
    mp_index = {}
    e_cam, e_pt, e_uv, e_info = [], [], [], []
    used_mps = []
    for mp in mps:
        edges = [kf for kf in mp.observations if not kf.is_bad and kf in cam_index]
        if not edges:
            continue  # vbNotIncludedMP (Optimizer.cc:157-159)
        mp_index[mp] = len(used_mps)
        used_mps.append(mp)
        for kf in edges:
            e_cam.append(cam_index[kf])
            e_pt.append(mp_index[mp])
            e_uv.append(mp.measurement_in_keyframe(kf))
            e_info.append(mp.info_in_keyframe(kf))
    if not e_cam:
        return

    use_dense = len(kfs) <= GLOBAL_BA_DENSE_MAX_CAMS
    p = ba.build_problem(
        np.stack([kf.Tcw for kf in kfs]),
        cam_fixed,
        np.stack([mp.world_pos for mp in used_mps]),
        e_cam, e_pt, e_uv, kfs[0].K, e_info=e_info, with_pairs=use_dense,
        device=device,
    )
    mesh = None if use_dense else global_ba_mesh(device)
    if use_dense:
        T_out, X_out, _ = ba.bundle_adjust(p, n_iters=n_iters, robust=robust)
    elif mesh is not None:
        # several cards: the edge set cut over the mesh, the camera and point
        # reductions summed on its first card (parallel/ba_sharded.py)
        from mono_slam_framework_torch import parallel

        T_out, X_out, _ = parallel.global_bundle_adjust_sharded(
            mesh, p, n_iters=n_iters, robust=robust, cg_iters=cg_iters
        )
    else:
        T_out, X_out, _ = ba.global_bundle_adjust(
            p, n_iters=n_iters, robust=robust, cg_iters=cg_iters
        )
    T_out, X_out = T_out.cpu().numpy(), X_out.cpu().numpy()

    for i, kf in enumerate(kfs):
        if loop_kf == 0:
            kf.set_pose(T_out[i])
        else:
            kf.Tcw_gba = T_out[i].copy()
            kf.ba_global_for_kf = loop_kf
    for mp, i in mp_index.items():
        if mp.is_bad:
            continue
        if loop_kf == 0:
            mp.set_world_pos(X_out[i])
            mp.update_normal_and_depth()
        else:
            mp.pos_gba = X_out[i].copy()
            mp.ba_global_for_kf = loop_kf
