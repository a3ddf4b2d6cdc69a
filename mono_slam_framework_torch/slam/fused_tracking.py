"""Steady-state tracking: the per-frame hot path on the device.

PyTorch counterpart of `mono_slam_framework_tpu/slam/fused_tracking.py`
(the reference's TrackWithMotionModel + TrackLocalMap, Tracking.cc:434-633,
minus host bookkeeping):

  * `motion_step`  — ORB extraction + Hamming match against the last frame
    + exact-pixel association through the last frame's keypoint map +
    motion-only pose LM;
  * `local_step`   — frustum visibility over the local-map candidates +
    batched matching against every active local keyframe + first-wins
    association + pose LM over the union;
  * `steady_step`  — both as one call: a map point is a local candidate iff
    no motion match of this frame saw it, and the local-keyframe window is
    the one computed after the previous frame.

Outputs are separate tensors in NamedTuples (no packed readback). The
`chain_px` / `union_row` / `T2` outputs of `steady_step` are the next
frame's `prev_px` / `prev_row` / motion-model input (`chain_T_init`), the
device-resident chain of the pipelined host mode. `HostCopy` brings the
fields the host replay reads (`steady_fields`, `motion_fields`,
`local_fields`) back with one synchronization.

`steady_core_batch` is `_steady_core` over N streams with a leading stream
axis on every argument (the counterpart of the JAX package's `jax.vmap` of
`_steady_core` in `parallel/multistream.py`). It is split at the two pose
LMs: the association before each LM and the bookkeeping after it carry the
stream axis as an explicit dimension, and each LM phase is ONE
`pose_opt.pose_optimize_batched` call for all N streams (one kernel B2
launch on a card). Stream i's outputs equal `_steady_core` on stream i's
inputs. `chain_T_init` takes a leading stream axis as it is.

Host bookkeeping semantics are kept on the device side exactly as in the
JAX package: per-pixel last-writer-wins for motion associations
(KeyPointMap::SetMapPoint overwrite), first-wins + existing-blocks for
local-map associations (Tracking.cc:620-631), and the inactive-keyframe
skip (a keyframe is matched only if it proposed a visible candidate).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mono_slam_framework_torch.geometry import se3
from mono_slam_framework_torch.ops import hamming, orb
from mono_slam_framework_torch.optim import pose_opt

NONE = -1


class MotionOut(NamedTuple):
    T1: torch.Tensor  # f32 [4,4] pose after the motion LM
    n_good: torch.Tensor  # int inliers of the motion LM
    n_matches: torch.Tensor  # int ratio-test matches against the last frame
    row: torch.Tensor  # int32 [K] map row per slot after association (-1 none)
    keep: torch.Tensor  # bool [K] association kept after per-pixel dedup
    inlier: torch.Tensor  # bool [K] motion-LM inlier
    idx2: torch.Tensor  # int64 [K] best last-frame slot
    ok: torch.Tensor  # bool [K] ratio test passed (and slot valid)


class LocalOut(NamedTuple):
    T2: torch.Tensor  # f32 [4,4] pose after the local LM
    n_good: torch.Tensor  # int inliers of the local LM
    new_row: torch.Tensor  # int32 [K] newly associated map row per slot
    inlier: torch.Tensor  # bool [K] local-LM inlier over old + new rows
    vis: torch.Tensor  # bool [R] frustum-visible candidate ctx rows


class SteadyOut(NamedTuple):
    cur: orb.Features
    motion: MotionOut
    local: LocalOut
    chain_px: torch.Tensor  # int32 [K] pixel index of final associations
    union_row: torch.Tensor  # int32 [K] final map row per slot (-1 none)


def _pixel_index(xy, cols: int):
    """Truncated (x, y) -> KeyPointMap index y*cols + x (featurematcher int
    truncation + KeyPointMap index, quirk B1)."""
    xy_i = xy.to(torch.int32)
    return xy_i[..., 1] * cols + xy_i[..., 0]


def _first_true(mask, dim):
    """Index of the first True along `dim` (0 where none)."""
    return torch.argmax(mask.to(torch.uint8), dim=dim)


def _info(cur: orb.Features, use_octave_info: bool):
    if use_octave_info:
        return torch.pow(1.2, -2.0 * cur.octave.to(torch.float32))
    return torch.ones(cur.octave.shape, dtype=torch.float32, device=cur.octave.device)


def _motion_core_feats(
    cur, prev_feats, prev_px, prev_row, mp_pos, T_init, K, ratio, cols,
    use_octave_info,
):
    """Match-vs-last + exact-pixel associate + pose LM on extracted features.
    Returns (T1, row, keep, inlier, n_good, idx2, ok)."""
    d = hamming.distance_matrix(cur.desc, prev_feats.desc, cur.valid, prev_feats.valid)
    idx2, ok = hamming.knn2_ratio_match(d, ratio)
    ok = ok & cur.valid

    # exact-pixel association through the LAST frame's keypoint map
    prev_idx = _pixel_index(prev_feats.xy[idx2], cols)
    eq = (prev_idx[:, None] == prev_px[None, :]) & (prev_row[None, :] >= 0)  # [K,M]
    row = torch.where(ok & eq.any(dim=1), prev_row[_first_true(eq, 1)], NONE)

    # per-CURRENT-pixel dedup, last writer wins (SetMapPoint overwrite while
    # the host loop walks matches in order, Tracking.cc:389-399)
    cur_idx = _pixel_index(cur.xy, cols)
    ar = torch.arange(cur_idx.shape[0], device=cur_idx.device)
    later_same = (
        (cur_idx[None, :] == cur_idx[:, None])
        & (row[None, :] >= 0)
        & (ar[None, :] > ar[:, None])
    )
    keep = (row >= 0) & ~later_same.any(dim=1)

    Xw = mp_pos[torch.clamp(row, min=0)]
    T1, inlier, n_good = pose_opt.pose_optimize(
        T_init, Xw, cur.xy, keep, K, _info(cur, use_octave_info)
    )
    return T1, row, keep, inlier, n_good, idx2, ok


def _frustum(pos, normal, maxdist, T, K, width, height):
    """Vectorized Frame::isInFrustum (Frame.cc:48-84) -> bool [C]."""
    R = T[:3, :3]
    t = T[:3, 3]
    Xc = pos @ R.T + t
    z_ok = Xc[:, 2] >= 0.0
    zs = torch.where(Xc[:, 2] == 0, 1.0, Xc[:, 2])
    u = K[0, 0] * Xc[:, 0] / zs + K[0, 2]
    v = K[1, 1] * Xc[:, 1] / zs + K[1, 2]
    in_img = (u >= 0.0) & (u <= width) & (v >= 0.0) & (v <= height)
    PO = pos - (-R.T @ t)
    dist = torch.linalg.norm(PO, dim=-1)
    safe = torch.where(dist == 0, 1.0, dist)
    cos_ok = torch.sum(PO * normal, dim=-1) / safe >= 0.5
    return z_ok & in_img & (dist <= maxdist) & cos_ok


def _local_core(
    cur, cur_row, T1, kf_feats, kf_px, kf_row, kf_active, mp_pos, K, ratio,
    cols, use_octave_info,
):
    """Batched local-KF matching + first-wins association + pose LM.
    Returns (T2, new_row, inlier, n_good)."""
    # match the current frame against all N keyframes at once: [N, K]
    d = hamming.distance_matrix(cur.desc, kf_feats.desc, cur.valid, kf_feats.valid)
    idx2, ok = hamming.knn2_ratio_match(d, ratio)
    ok = ok & cur.valid
    kf_xy = torch.gather(kf_feats.xy, 1, idx2[..., None].expand(*idx2.shape, 2))
    kf_idx = _pixel_index(kf_xy, cols)
    eq = (kf_idx[:, :, None] == kf_px[:, None, :]) & (kf_row[:, None, :] >= 0)
    rows_nk = torch.where(
        ok & eq.any(dim=-1), torch.gather(kf_row, 1, _first_true(eq, -1)), NONE
    )
    rows_nk = torch.where(kf_active[:, None], rows_nk, NONE)

    # merge: an existing association blocks (the mp1-is-None check at
    # Tracking.cc:620-631); among new proposals the host walks results in
    # (keyframe, row) order and the first SetMapPoint wins the pixel
    first_kf = _first_true(rows_nk >= 0, 0)  # [K]
    any_new = (rows_nk >= 0).any(dim=0)
    proposed = torch.gather(rows_nk, 0, first_kf[None])[0]
    cur_idx = _pixel_index(cur.xy, cols)
    k = cur_idx.shape[0]
    ar = torch.arange(k, device=cur_idx.device)
    same_px = cur_idx[None, :] == cur_idx[:, None]
    pixel_taken = (same_px & (cur_row[None, :] >= 0)).any(dim=1)
    new_row = torch.where(any_new & (cur_row < 0) & ~pixel_taken, proposed, NONE)
    # first-wins among new rows sharing a pixel, in (kf, slot) order
    order = first_kf * (k + 1) + ar
    earlier_new = same_px & (new_row[None, :] >= 0) & (order[None, :] < order[:, None])
    new_row = torch.where(earlier_new.any(dim=1), NONE, new_row)

    union_row = torch.where(cur_row >= 0, cur_row, new_row)
    Xw = mp_pos[torch.clamp(union_row, min=0)]
    T2, inlier, n_good = pose_opt.pose_optimize(
        T1, Xw, cur.xy, union_row >= 0, K, _info(cur, use_octave_info)
    )
    return T2, new_row, inlier, n_good


def _kf_active(vis, first_slot, n_kf: int):
    """A keyframe is matched only if it proposed a visible candidate
    (the n_to_match > 0 gate, Tracking.cc:600-609)."""
    active = torch.zeros(n_kf, dtype=torch.int32, device=vis.device)
    active = active.scatter_reduce(
        0, torch.clamp(first_slot, min=0).long(), vis.to(torch.int32), "amax"
    )
    return active > 0


def motion_step(
    img, prev_feats, prev_px, prev_row, mp_pos, T_init, K, ratio: float,
    cols: int, use_octave_info: bool, max_features: int, fast_threshold: float,
):
    """Extract + match-vs-last + associate + pose LM.
    Returns (cur Features, MotionOut)."""
    cur = orb.extract(img, max_features, fast_threshold)
    T1, row, keep, inlier, n_good, idx2, ok = _motion_core_feats(
        cur, prev_feats, prev_px, prev_row, mp_pos, T_init, K, ratio, cols,
        use_octave_info,
    )
    n_matches = torch.sum(ok.to(torch.int32))
    return cur, MotionOut(T1, n_good, n_matches, row, keep, inlier, idx2, ok)


def local_step(
    cur_feats, cur_row, T1, kf_feats, kf_px, kf_row, cand_mask, first_slot,
    ctx_normal, ctx_maxdist, mp_pos, T_for_frustum, K, ratio: float, cols: int,
    width: float, height: float, use_octave_info: bool = True,
):
    """Frustum + batched local-KF matching + association + pose LM over
    candidates in the cached ctx row space (`cand_mask` is the host's
    last_frame_seen filter). Returns LocalOut."""
    R = first_slot.shape[0]
    vis = (
        _frustum(mp_pos[:R], ctx_normal, ctx_maxdist, T_for_frustum, K, width, height)
        & (first_slot >= 0)
        & cand_mask
    )
    T2, new_row, inlier, n_good = _local_core(
        cur_feats, cur_row, T1, kf_feats, kf_px, kf_row,
        _kf_active(vis, first_slot, kf_px.shape[0]), mp_pos, K, ratio, cols,
        use_octave_info,
    )
    return LocalOut(T2, n_good, new_row, inlier, vis)


def _steady_core(
    cur, prev_feats, prev_px, prev_row, mp_pos, T_init, kf_feats, kf_px,
    kf_row, first_slot, ctx_normal, ctx_maxdist, K, ratio, cols, width,
    height, use_octave_info,
) -> SteadyOut:
    """The post-extraction body of `steady_step`."""
    T1, row, keep, inlier, n_good, idx2, ok = _motion_core_feats(
        cur, prev_feats, prev_px, prev_row, mp_pos, T_init, K, ratio, cols,
        use_octave_info,
    )
    motion = MotionOut(
        T1, n_good, torch.sum(ok.to(torch.int32)), row, keep, inlier, idx2, ok
    )

    # inliers carry into the local phase (the host replay drops outliers
    # before SearchLocalPoints; same rule here)
    cur_row = torch.where(keep & inlier, row, NONE)

    # device twin of the last_frame_seen stamps: every row a motion match
    # touched is excluded from the candidate set
    seen = torch.zeros(mp_pos.shape[0], dtype=torch.int32, device=row.device)
    seen = seen.scatter_reduce(
        0, torch.clamp(row, min=0).long(), keep.to(torch.int32), "amax"
    )
    R = first_slot.shape[0]
    vis = (
        _frustum(mp_pos[:R], ctx_normal, ctx_maxdist, T1, K, width, height)
        & (first_slot >= 0)
        & (seen[:R] == 0)
    )
    T2, new_row, inlier2, n_good2 = _local_core(
        cur, cur_row, T1, kf_feats, kf_px, kf_row,
        _kf_active(vis, first_slot, kf_px.shape[0]), mp_pos, K, ratio, cols,
        use_octave_info,
    )

    # next-frame chain state: this frame's final associations as the next
    # frame's prev tables
    union_row = torch.where(cur_row >= 0, cur_row, new_row)
    chain_px = torch.where(union_row >= 0, _pixel_index(cur.xy, cols), NONE)
    return SteadyOut(
        cur, motion, LocalOut(T2, n_good2, new_row, inlier2, vis), chain_px,
        union_row,
    )


def steady_step(
    img,  # [H,W] f32 (or u8)
    prev_feats: orb.Features,
    prev_px,  # int32 [M] pixel index of last-frame associations
    prev_row,  # int32 [M] row into mp_pos (-1 = padding)
    mp_pos,  # f32 [P,3] positions over ctx rows + per-frame extensions
    T_init,  # f32 [4,4]
    kf_feats: orb.Features,  # stacked [N, ...] local-KF context
    kf_px,  # int32 [N,M2]
    kf_row,  # int32 [N,M2] rows into mp_pos
    first_slot,  # int32 [R] first KF slot proposing each ctx row (-1 pad)
    ctx_normal,  # f32 [R,3] viewing normals over ctx rows
    ctx_maxdist,  # f32 [R]
    K,  # f32 [3,3]
    ratio: float,
    cols: int,
    width: float,
    height: float,
    use_octave_info: bool,
    max_features: int,
    fast_threshold: float,
) -> SteadyOut:
    """Motion + local tracking of one frame, on the device of `img`.

    A ctx row is a local candidate iff no motion match saw it this frame
    (the device twin of the last_frame_seen stamp walk,
    Tracking.cc:577-599).
    """
    cur = orb.extract(img, max_features, fast_threshold)
    return _steady_core(
        cur, prev_feats, prev_px, prev_row, mp_pos, T_init, kf_feats, kf_px,
        kf_row, first_slot, ctx_normal, ctx_maxdist, K, ratio, cols, width,
        height, use_octave_info,
    )


# ---------------------------------------------------------------------------
# N streams with a leading stream axis (the multi-stream serving mode)


def _rows_of(table, idx):
    """table [N, P, ...] gathered at idx [N, K] along the row axis."""
    idx = idx.long()
    return torch.gather(table, 1, idx.reshape(*idx.shape, *(1,) * (table.dim() - 2))
                        .expand(*idx.shape, *table.shape[2:]))


def _motion_assoc_batch(cur, prev_feats, prev_px, prev_row, ratio, cols):
    """`_motion_core_feats`'s association over [N, ...]: match against the
    last frame, exact-pixel association, per-pixel last-writer-wins.
    Returns (row, keep, idx2, ok), each [N, K]."""
    d = hamming.distance_matrix(cur.desc, prev_feats.desc, cur.valid, prev_feats.valid)
    idx2, ok = hamming.knn2_ratio_match(d, ratio)
    ok = ok & cur.valid
    prev_idx = _pixel_index(_rows_of(prev_feats.xy, idx2), cols)
    eq = (prev_idx[:, :, None] == prev_px[:, None, :]) & (prev_row[:, None, :] >= 0)
    row = torch.where(ok & eq.any(dim=2),
                      torch.gather(prev_row, 1, _first_true(eq, 2)), NONE)
    cur_idx = _pixel_index(cur.xy, cols)
    ar = torch.arange(cur_idx.shape[1], device=cur_idx.device)
    later_same = (
        (cur_idx[:, None, :] == cur_idx[:, :, None])
        & (row[:, None, :] >= 0)
        & (ar[None, :] > ar[:, None])
    )
    keep = (row >= 0) & ~later_same.any(dim=2)
    return row, keep, idx2, ok


def _frustum_batch(pos, normal, maxdist, T, K, width, height):
    """`_frustum` over N streams: pos [N, C, 3], T [N, 4, 4], K [N, 3, 3]
    -> bool [N, C]."""
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    Xc = pos @ R.transpose(1, 2) + t[:, None]
    z_ok = Xc[..., 2] >= 0.0
    zs = torch.where(Xc[..., 2] == 0, 1.0, Xc[..., 2])
    u = K[:, 0, 0, None] * Xc[..., 0] / zs + K[:, 0, 2, None]
    v = K[:, 1, 1, None] * Xc[..., 1] / zs + K[:, 1, 2, None]
    in_img = (u >= 0.0) & (u <= width) & (v >= 0.0) & (v <= height)
    PO = pos - (-R.transpose(1, 2) @ t[..., None])[:, None, :, 0]
    dist = torch.linalg.norm(PO, dim=-1)
    safe = torch.where(dist == 0, 1.0, dist)
    cos_ok = torch.sum(PO * normal, dim=-1) / safe >= 0.5
    return z_ok & in_img & (dist <= maxdist) & cos_ok


def _kf_active_batch(vis, first_slot, n_kf: int):
    """`_kf_active` over N streams: vis, first_slot [N, R] -> bool [N, n_kf]."""
    active = torch.zeros((vis.shape[0], n_kf), dtype=torch.int32, device=vis.device)
    active = active.scatter_reduce(
        1, torch.clamp(first_slot, min=0).long(), vis.to(torch.int32), "amax"
    )
    return active > 0


def _local_assoc_batch(cur, cur_row, kf_feats, kf_px, kf_row, kf_active, ratio, cols):
    """`_local_core`'s association over N streams: every stream's frame
    against its NK local keyframes at once ([N, NK, K]), first-wins merge.
    Returns new_row [N, K]."""
    d = hamming.distance_matrix(
        cur.desc[:, None], kf_feats.desc, cur.valid[:, None], kf_feats.valid
    )
    idx2, ok = hamming.knn2_ratio_match(d, ratio)  # [N, NK, K]
    ok = ok & cur.valid[:, None]
    kf_xy = torch.gather(kf_feats.xy, 2, idx2[..., None].expand(*idx2.shape, 2))
    kf_idx = _pixel_index(kf_xy, cols)
    eq = (kf_idx[..., :, None] == kf_px[:, :, None, :]) & (kf_row[:, :, None, :] >= 0)
    rows_nk = torch.where(
        ok & eq.any(dim=-1), torch.gather(kf_row, 2, _first_true(eq, -1)), NONE
    )
    rows_nk = torch.where(kf_active[..., None], rows_nk, NONE)

    first_kf = _first_true(rows_nk >= 0, 1)  # [N, K]
    any_new = (rows_nk >= 0).any(dim=1)
    proposed = torch.gather(rows_nk, 1, first_kf[:, None])[:, 0]
    cur_idx = _pixel_index(cur.xy, cols)
    k = cur_idx.shape[1]
    ar = torch.arange(k, device=cur_idx.device)
    same_px = cur_idx[:, None, :] == cur_idx[:, :, None]
    pixel_taken = (same_px & (cur_row[:, None, :] >= 0)).any(dim=2)
    new_row = torch.where(any_new & (cur_row < 0) & ~pixel_taken, proposed, NONE)
    order = first_kf * (k + 1) + ar
    earlier_new = (
        same_px & (new_row[:, None, :] >= 0) & (order[:, None, :] < order[:, :, None])
    )
    return torch.where(earlier_new.any(dim=2), NONE, new_row)


def steady_core_batch(
    cur, prev_feats, prev_px, prev_row, mp_pos, T_init, kf_feats, kf_px,
    kf_row, first_slot, ctx_normal, ctx_maxdist, K, ratio, cols, width,
    height, use_octave_info,
) -> SteadyOut:
    """`_steady_core` over N streams: every argument of `_steady_core` with
    a leading stream axis (cur / prev_feats [N, K, ...], prev_px / prev_row
    [N, M], mp_pos [N, P, 3], T_init [N, 4, 4], kf_feats [N, NK, K2, ...],
    kf_px / kf_row [N, NK, M2], first_slot / ctx_maxdist [N, R], ctx_normal
    [N, R, 3], K [N, 3, 3]); the statics are shared. Two pose-LM calls for
    all N streams. Returns a SteadyOut whose every field has the leading N.

    Streams padded to common table sizes keep their results when the pads
    are the JAX package's fills: -1 in prev_px / prev_row / kf_px / kf_row /
    first_slot, zeros in ctx_normal / ctx_maxdist and at the end of mp_pos
    (which must hold at least R rows), and a real keyframe's features with
    kf_row -1 in a padded keyframe slot. A padded ctx row is never visible
    (first_slot -1), a padded keyframe slot never active (no first_slot
    names it), and no padded table entry matches.
    """
    info = _info(cur, use_octave_info)
    row, keep, idx2, ok = _motion_assoc_batch(cur, prev_feats, prev_px, prev_row, ratio, cols)
    T1, inlier, n_good = pose_opt.pose_optimize_batched(
        T_init, _rows_of(mp_pos, torch.clamp(row, min=0)), cur.xy, keep, K, info
    )
    motion = MotionOut(
        T1, n_good, torch.sum(ok.to(torch.int32), dim=1), row, keep, inlier, idx2, ok
    )

    cur_row = torch.where(keep & inlier, row, NONE)
    seen = torch.zeros(mp_pos.shape[:2], dtype=torch.int32, device=row.device)
    seen = seen.scatter_reduce(
        1, torch.clamp(row, min=0).long(), keep.to(torch.int32), "amax"
    )
    R = first_slot.shape[1]
    vis = (
        _frustum_batch(mp_pos[:, :R], ctx_normal, ctx_maxdist, T1, K, width, height)
        & (first_slot >= 0)
        & (seen[:, :R] == 0)
    )
    new_row = _local_assoc_batch(
        cur, cur_row, kf_feats, kf_px, kf_row,
        _kf_active_batch(vis, first_slot, kf_px.shape[1]), ratio, cols,
    )
    union_row = torch.where(cur_row >= 0, cur_row, new_row)
    T2, inlier2, n_good2 = pose_opt.pose_optimize_batched(
        T1, _rows_of(mp_pos, torch.clamp(union_row, min=0)), cur.xy, union_row >= 0, K, info
    )
    chain_px = torch.where(union_row >= 0, _pixel_index(cur.xy, cols), NONE)
    return SteadyOut(
        cur, motion, LocalOut(T2, n_good2, new_row, inlier2, vis), chain_px, union_row,
    )


def chain_T_init(T_prev, T_prev2):
    """The motion model on the device: T_init = velocity @ T_prev with
    velocity = T_prev @ inv(T_prev2) (Tracking.cc:155-165); [..., 4, 4]."""
    return T_prev @ se3.inverse(T_prev2) @ T_prev


def motion_fields(cur: orb.Features, motion: MotionOut) -> dict:
    """What the host replay reads of a motion step (the JAX package's
    `_motion_pack` fields the replay unpacks), by name."""
    return {
        "T1": motion.T1, "n_matches": motion.n_matches, "row": motion.row,
        "keep": motion.keep, "inlier": motion.inlier, "idx2": motion.idx2,
        "ok": motion.ok, "xy": cur.xy, "octave": cur.octave,
    }


def local_fields(local: LocalOut) -> dict:
    """What the host replay reads of a local step, by name."""
    return {"T2": local.T2, "new_row": local.new_row, "inlier2": local.inlier,
            "vis": local.vis}


def steady_fields(out: SteadyOut) -> dict:
    """What the host replay reads of a steady step, by name."""
    return {**motion_fields(out.cur, out.motion), **local_fields(out.local)}


class HostCopy:
    """A device->host copy of named tensors with ONE synchronization.

    On a card the copies start at construction: each tensor goes into a
    pinned host tensor of its own dtype with `non_blocking=True`, then one
    CUDA event is recorded behind them on the current stream. `wait()`
    synchronizes on that event once and returns numpy arrays. The device
    tensors stay referenced until then. On the CPU there is nothing to copy.
    """

    def __init__(self, tensors: dict):
        device = next(iter(tensors.values())).device
        self._event = None
        self._src = None
        if device.type == "cuda":
            self._host = {
                k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                for k, v in tensors.items()
            }
            for k, v in tensors.items():
                self._host[k].copy_(v, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))
            self._src = tensors
        else:
            self._host = {k: v.detach() for k, v in tensors.items()}

    def wait(self) -> dict:
        """The fields as numpy arrays, after the copy has landed."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
            self._src = None
        return {k: v.numpy() for k, v in self._host.items()}
