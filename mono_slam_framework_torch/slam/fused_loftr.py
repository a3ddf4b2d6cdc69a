"""Fused steady-state tracking for the DNN (LoFTR) matcher.

PyTorch counterpart of `mono_slam_framework_tpu/slam/fused_loftr.py`: the
LoFTR matcher's twin of the ORB one-step path (slam/fused_tracking.py +
slam/fused_host.py). Without it a LoFTR System runs the reference-twin host
flow (several host round trips per frame and one transformer call per
pairwise match).

LoFTR frames have a natural fixed-shape "keypoint" set: the L = 30x40 =
1200 coarse cells of the /16 feature grid (dnnfeaturematcher.cpp:75-100
decode). A frame's association state is therefore a dense [L] row table
(map-point row per cell, -1 = none), and per-pixel dedup is free (distinct
cells decode to distinct pixels).

`loftr_core_batch` is `_loftr_core` over N streams with a leading stream
axis (parallel/multistream.py's `steady_step_loftr_batch`).

`steady_step_loftr` runs, on the device of its image:
  encode (backbone + positional encoding)            models/loftr_native.py
  -> pairwise transformer + dual softmax vs the last frame (argmax per cell)
  -> cell-table association + motion pose LM           TrackWithMotionModel
  -> candidate filter (frustum + not seen this frame)   SearchLocalPoints
  -> ONE batched transformer pass over the local keyframes [N, L, L],
     first-keyframe-wins merge
  -> pose LM over the union                             TrackLocalMap
Both pose LMs are `pose_opt.pose_optimize`, kernel B2 on a card, at L edge
slots with the coarse-cell information weight. The local-keyframe window is
the one computed after the previous frame (one frame stale, refreshed after
the readback), the same deliberate deviation as the ORB one-step path.

The host reads the outputs back once per frame (`fused_tracking.HostCopy`)
and replays them with the unfused semantics (tracking.py's
track_with_motion_model + track_local_map); it returns None, and the caller
falls back to the reference-twin flow, whenever a precondition fails.
Tables are passed at their own sizes: the ctx row space has `nrows` rows
(`rcap` = `nrows`), extension rows start there, and there are `n_kf`
keyframe slots (no power-of-two or ladder capacities). As in the JAX
package, this replay has no inlier-floor gate (fused_host's
`fusedInlierFloorShare`), see ROADMAP C.4.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mono_slam_framework_torch.matchers import loftr_matcher as lm
from mono_slam_framework_torch.matchers.base import MatchFramesResult
from mono_slam_framework_torch.models import loftr_native
from mono_slam_framework_torch.optim import pose_opt
from mono_slam_framework_torch.slam import fused_host, fused_tracking

NONE = -1


class LoftrOut(NamedTuple):
    T1: torch.Tensor  # f32 [4,4] pose after the motion LM
    n_good1: torch.Tensor  # int inliers of the motion LM
    n_matches: torch.Tensor  # int cells matched to the last frame above threshold
    row: torch.Tensor  # int [L] map row per cell after association (-1 none)
    okm: torch.Tensor  # bool [L] cell matched above threshold
    inlier1: torch.Tensor  # bool [L] motion-LM inlier
    j1: torch.Tensor  # int64 [L] best last-frame cell per cell
    T2: torch.Tensor  # f32 [4,4] pose after the local LM
    n_good2: torch.Tensor  # int inliers of the local LM
    new_row: torch.Tensor  # int [L] newly associated map row per cell
    inlier2: torch.Tensor  # bool [L] local-LM inlier over old + new rows
    vis: torch.Tensor  # bool [R] frustum-visible candidate ctx rows


# what the host replay reads, in the order of the JAX package's packed layout
FIELDS = ("T1", "n_matches", "row", "okm", "inlier1", "j1", "T2", "new_row",
          "inlier2", "vis")


def loftr_fields(out: LoftrOut) -> dict:
    """The fields the host replay reads of a steady step, by name."""
    return {k: getattr(out, k) for k in FIELDS}


def _best(conf):
    """Argmax over the last axis of a confidence stack and its value."""
    j = torch.argmax(conf, dim=-1)
    return j, torch.gather(conf, -1, j[..., None])[..., 0]


def _loftr_core(
    f_cur, model, f_prev, prev_cellrow, mp_pos, T_init, kf_feats, kf_cellrow,
    first_slot, ctx_normal, ctx_maxdist, cell_uv, K, info_val, threshold: float,
    width: float, height: float,
):
    """The post-encode body of `steady_step_loftr` on encoded features.
    Returns (LoftrOut, union_row, T2): union_row is this frame's final
    per-cell association table, the next frame's prev_cellrow."""
    L = f_cur.shape[1]

    # ---- motion phase: match against the last frame -----------------------
    conf = loftr_native.confidence_from_features(model, f_cur, f_prev)[0]
    j1, v1 = _best(conf)  # best last-frame cell per current cell
    okm = v1 > threshold
    row = torch.where(okm, prev_cellrow[j1], NONE)
    keep = row >= 0
    n_matches = torch.sum(okm.to(torch.int32))

    info = torch.full((L,), float(info_val), dtype=torch.float32, device=f_cur.device)
    T1, inlier1, n_good1 = pose_opt.pose_optimize(
        T_init, mp_pos[torch.clamp(row, min=0)], cell_uv, keep, K, info
    )

    # ---- candidate filter (the device twin of the last_frame_seen stamps) --
    seen = torch.zeros(mp_pos.shape[0], dtype=torch.int32, device=row.device)
    seen = seen.scatter_reduce(0, torch.clamp(row, min=0).long(), keep.to(torch.int32), "amax")
    R = first_slot.shape[0]
    vis = (
        fused_tracking._frustum(mp_pos[:R], ctx_normal, ctx_maxdist, T1, K, width, height)
        & (first_slot >= 0)
        & (seen[:R] == 0)
    )
    n_kf = kf_feats.shape[0]
    kf_active = fused_tracking._kf_active(vis, first_slot, n_kf)

    # ---- local phase: every local keyframe in one batched pass -------------
    c = loftr_native.confidence_from_features(model, f_cur.expand(n_kf, -1, -1), kf_feats)
    j, v = _best(c)  # [N, L]
    # proposals are NOT restricted to visible candidates: the unfused
    # SearchLocalPoints associates ANY map point of a matched keyframe
    # (Tracking.cc:620-631); vis only gates which keyframes are matched
    rows_nk = torch.where((v > threshold) & kf_active[:, None],
                          torch.gather(kf_cellrow, 1, j), NONE)

    cur_row = torch.where(keep & inlier1, row, NONE)
    first_kf = fused_tracking._first_true(rows_nk >= 0, 0)
    any_new = (rows_nk >= 0).any(dim=0)
    proposed = torch.gather(rows_nk, 0, first_kf[None])[0]
    new_row = torch.where(any_new & (cur_row < 0), proposed, NONE)

    union_row = torch.where(cur_row >= 0, cur_row, new_row)
    T2, inlier2, n_good2 = pose_opt.pose_optimize(
        T1, mp_pos[torch.clamp(union_row, min=0)], cell_uv, union_row >= 0, K, info
    )
    out = LoftrOut(T1, n_good1, n_matches, row, okm, inlier1, j1, T2, n_good2,
                   new_row, inlier2, vis)
    return out, union_row, T2


def loftr_core_batch(
    f_cur, model, f_prev, prev_cellrow, mp_pos, T_init, kf_feats, kf_cellrow,
    first_slot, ctx_normal, ctx_maxdist, cell_uv, K, info_val, threshold: float,
    width: float, height: float,
):
    """`_loftr_core` over N streams: f_cur / f_prev [N, L, C], prev_cellrow
    [N, L], mp_pos [N, P, 3], T_init [N, 4, 4], kf_feats [N, NK, L, C],
    kf_cellrow [N, NK, L], first_slot / ctx_maxdist [N, R], ctx_normal
    [N, R, 3], K [N, 3, 3]; the cell grid, the information weight and the
    statics are shared. The transformer runs once over the N pairs of the
    motion phase and once over the N x NK pairs of the local phase; each
    pose LM is ONE `pose_opt.pose_optimize_batched` call for all N streams.
    Returns (LoftrOut, union_row, T2), every field with the leading N.
    Padding as in `fused_tracking.steady_core_batch` (a padded keyframe slot
    holds a real keyframe's features and kf_cellrow -1)."""
    n, L, C = f_cur.shape
    conf = loftr_native.confidence_from_features(model, f_cur, f_prev)
    j1, v1 = _best(conf)  # [N, L]
    okm = v1 > threshold
    row = torch.where(okm, torch.gather(prev_cellrow, 1, j1), NONE)
    keep = row >= 0
    n_matches = torch.sum(okm.to(torch.int32), dim=1)

    info = torch.full((n, L), float(info_val), dtype=torch.float32, device=f_cur.device)
    uv = cell_uv.expand(n, L, 2)
    T1, inlier1, n_good1 = pose_opt.pose_optimize_batched(
        T_init, fused_tracking._rows_of(mp_pos, torch.clamp(row, min=0)), uv, keep, K, info
    )

    seen = torch.zeros(mp_pos.shape[:2], dtype=torch.int32, device=row.device)
    seen = seen.scatter_reduce(1, torch.clamp(row, min=0).long(), keep.to(torch.int32), "amax")
    R = first_slot.shape[1]
    vis = (
        fused_tracking._frustum_batch(mp_pos[:, :R], ctx_normal, ctx_maxdist, T1, K, width,
                                      height)
        & (first_slot >= 0)
        & (seen[:, :R] == 0)
    )
    n_kf = kf_feats.shape[1]
    kf_active = fused_tracking._kf_active_batch(vis, first_slot, n_kf)

    c = loftr_native.confidence_from_features(
        model, f_cur[:, None].expand(n, n_kf, L, C).reshape(n * n_kf, L, C),
        kf_feats.reshape(n * n_kf, L, C),
    ).reshape(n, n_kf, L, L)
    j, v = _best(c)  # [N, NK, L]
    rows_nk = torch.where((v > threshold) & kf_active[..., None],
                          torch.gather(kf_cellrow, 2, j), NONE)

    cur_row = torch.where(keep & inlier1, row, NONE)
    first_kf = fused_tracking._first_true(rows_nk >= 0, 1)
    any_new = (rows_nk >= 0).any(dim=1)
    proposed = torch.gather(rows_nk, 1, first_kf[:, None])[:, 0]
    new_row = torch.where(any_new & (cur_row < 0), proposed, NONE)

    union_row = torch.where(cur_row >= 0, cur_row, new_row)
    T2, inlier2, n_good2 = pose_opt.pose_optimize_batched(
        T1, fused_tracking._rows_of(mp_pos, torch.clamp(union_row, min=0)), uv,
        union_row >= 0, K, info,
    )
    out = LoftrOut(T1, n_good1, n_matches, row, okm, inlier1, j1, T2, n_good2,
                   new_row, inlier2, vis)
    return out, union_row, T2


def steady_step_loftr(
    img,  # [H,W] f32 grayscale at its own size (resized to the model's here)
    model,  # loftr_native.LoftrCoarse
    f_prev,  # [1,L,C] the last frame's encoded features
    prev_cellrow,  # int [L] map row per LAST-frame cell (-1 none)
    mp_pos,  # f32 [P,3] positions over ctx rows + extension rows
    T_init,  # f32 [4,4] velocity-model initial pose
    kf_feats,  # f32 [N,L,C] stacked local-keyframe features
    kf_cellrow,  # int [N,L] map row per keyframe cell (-1 none)
    first_slot,  # int32 [R] first keyframe slot proposing each ctx row
    ctx_normal,  # f32 [R,3]
    ctx_maxdist,  # f32 [R]
    cell_uv,  # f32 [L,2] image-pixel coordinates of each cell corner
    K,  # f32 [3,3]
    info_val: float,  # InvSigma2 of the coarse-cell measurement
    threshold: float,
    width: float,
    height: float,
):
    """One LoFTR steady frame. Returns (f_cur, LoftrOut, union_row, T2):
    the last two stay on the device as the chain of the NEXT frame's
    speculative dispatch."""
    f_cur = loftr_native.encode(model, lm.to_model(img))
    out, union_row, T2 = _loftr_core(
        f_cur, model, f_prev, prev_cellrow, mp_pos, T_init, kf_feats, kf_cellrow,
        first_slot, ctx_normal, ctx_maxdist, cell_uv, K, info_val, threshold,
        width, height,
    )
    return f_cur, out, union_row, T2


# ---------------------------------------------------------------------------
# host side


def applicable(tracker) -> bool:
    """Fused-LoFTR preconditions: steady OK-state motion-model tracking with
    the LoFTR matcher in its coarse (fine=False) configuration."""
    return (
        getattr(tracker.params, "fusedTracking", False)
        and getattr(tracker.params, "fusedOneStep", False)
        and isinstance(tracker.matcher, lm.LoftrFeatureMatcher)
        and not tracker.matcher.fine
        and tracker.velocity is not None
        and tracker.current_frame.id >= tracker.last_reloc_frame_id + 2
    )


def _cell_tables(tracker) -> dict:
    """Per-resolution cell decode tables: flat pixel index and pixel
    coordinates of every coarse cell corner (the matcher's decode)."""
    kp = tracker.current_frame.keypoint_map
    cols, rows = kp.cols, kp.rows
    key = (tracker.img_height, tracker.img_width, cols)
    cached = getattr(tracker, "_loftr_cell_tables", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    sx = cols / lm.MODEL_W
    sy = rows / lm.MODEL_H
    cells = np.arange(lm.L)
    x = ((cells % lm.GRID_W) * lm.CELL * sx).astype(np.int32)
    y = ((cells // lm.GRID_W) * lm.CELL * sy).astype(np.int32)
    uv_host = np.stack([x, y], -1).astype(np.float32)
    tables = {
        "pix": x + y * cols,  # int [L] flat pixel index per cell
        "uv": fused_host._upload(tracker, uv_host),
        "uv_host": uv_host,
        "cell_of_pix": {int(p): int(c) for c, p in enumerate(x + y * cols)},
        "scale": (sx, sy),
    }
    tracker._loftr_cell_tables = (key, tables)
    return tables


def _info_val(tracker, m, tables) -> float:
    if not tracker.octave_information:
        return 1.0
    return float(1.2 ** (-2.0 * m._sigma_octave(tables["scale"])))


def _ensure_ctx(tracker, m, tables) -> dict:
    """Local-map device context for the LoFTR path: the stacked keyframe
    features, the dense per-cell row tables and the row-space geometry.
    Rebuilt only when the local-keyframe set, any member's KeyPointMap
    version, or the map's geometry epoch changes (or a cached point turned
    bad), as fused_host._ensure_ctx."""
    local_kfs = sorted(tracker.local_keyframes, key=lambda kf: kf.id)
    n_kf = len(local_kfs)
    ckey = (
        tuple(kf.id for kf in local_kfs),
        tuple(kf.keypoint_map.version for kf in local_kfs),
        tracker.map.geometry_epoch,
    )
    ctx = getattr(tracker, "_loftr_lm_ctx", None)
    if ctx is not None and ctx["key"] == ckey and not any(mp.is_bad for mp in ctx["mps"]):
        return ctx
    fused_host.count(tracker, "ctx_builds")

    cell_of_pix = tables["cell_of_pix"]
    row_of: dict = {}
    mps: list = []
    first_slot_of: list = []
    kf_cellrow = np.full((n_kf, lm.L), -1, np.int32)
    for kslot, kf in enumerate(local_kfs):
        for pix, item in kf.keypoint_map.items():
            mp = item.map_point
            if mp is None or mp.is_bad:
                continue
            cell = cell_of_pix.get(pix)
            if cell is None:
                continue  # association off the cell lattice (relocalization)
            r = row_of.get(id(mp))
            if r is None:
                r = len(mps)
                row_of[id(mp)] = r
                mps.append(mp)
                first_slot_of.append(kslot)
            kf_cellrow[kslot, cell] = r

    nrows = len(mps)
    first_slot = np.asarray(first_slot_of, np.int32).reshape(nrows)
    pos = np.zeros((nrows, 3), np.float32)
    nrm = np.zeros((nrows, 3), np.float32)
    maxd = np.zeros(nrows, np.float32)
    for r, mp in enumerate(mps):
        pos[r] = mp.world_pos
        nrm[r] = mp.normal
        maxd[r] = mp.distance_invariance()

    stack_key = tuple(kf.id for kf in local_kfs)
    stack_cache = getattr(tracker, "_loftr_stack_cache", None)
    if stack_cache is not None and stack_cache[0] == stack_key:
        kf_feats = stack_cache[1]
    else:
        kf_feats = torch.cat([m._features(kf)[0] for kf in local_kfs], dim=0)
        tracker._loftr_stack_cache = (stack_key, kf_feats)

    # the position table keeps at least one row: gathers clamp row -1 to 0
    pos_dev = np.zeros((max(nrows, 1), 3), np.float32)
    pos_dev[:nrows] = pos
    ctx = {
        "key": ckey,
        "n_kf": n_kf,
        "rcap": nrows,  # extension rows start here
        "row_of": row_of,
        "mps": mps,
        "first_slot": first_slot,
        "pos": pos,
        "normal": nrm,
        "maxdist": maxd,
        "kf_feats": kf_feats,
        "kf_cellrow": fused_host._upload(tracker, kf_cellrow),
        "first_slot_d": fused_host._upload(tracker, first_slot),
        "normal_d": fused_host._upload(tracker, nrm),
        "maxdist_d": fused_host._upload(tracker, maxd),
        "mp_pos_d": fused_host._upload(tracker, pos_dev),
    }
    tracker._loftr_lm_ctx = ctx
    return ctx


def _prev_cellrow(tracker, ctx, tables):
    """The last frame's associations as a dense per-cell row table; points
    outside the ctx row space get extension rows from nrows on. Returns
    (prev_cellrow, ext)."""
    nrows = ctx["rcap"]
    prev_cellrow = np.full(lm.L, -1, np.int32)
    ext: list = []
    ext_rows: dict = {}
    cell_of_pix = tables["cell_of_pix"]
    for pix, item in tracker.last_frame.keypoint_map.items():
        mp = item.map_point
        if mp is None:
            continue
        cell = cell_of_pix.get(pix)
        if cell is None:
            continue
        r = ctx["row_of"].get(id(mp))
        if r is None:
            r = ext_rows.get(id(mp))
            if r is None:
                r = nrows + len(ext)
                ext_rows[id(mp)] = r
                ext.append(mp)
        prev_cellrow[cell] = r
    return prev_cellrow, ext


def run_steady(tracker) -> bool | None:
    """One LoFTR steady frame with ONE readback. Returns the final tracking
    ok, or None to fall back to the reference-twin flow. A step dispatched
    ahead by `dispatch_steady_spec` (pipelined mode) is consumed here after
    revalidation, as in fused_host.run_steady."""
    m = tracker.matcher
    cur = tracker.current_frame
    if not tracker.local_keyframes:
        fused_host.count(tracker, "fallback_no_window")
        return None
    tables = _cell_tables(tracker)

    spec = getattr(tracker, "_pipe_spec", None)
    tracker._pipe_spec = None
    if spec is not None and spec.get("kind") != "loftr":
        spec = None
    if spec is not None:
        ctx = _ensure_ctx(tracker, m, tables)
        if spec["prev_frame_id"] != tracker.last_frame.id:
            fused_host.count(tracker, "miss_frame")
            spec = None
        elif spec["ctx"] is not ctx:
            fused_host.count(tracker, "miss_ctx")
            spec = None
        elif tracker.last_frame.keypoint_map.version != 0:
            fused_host.count(tracker, "miss_version")
            spec = None
    if spec is not None:
        tracker.update_last_frame()
        cur.keypoint_map.clear()
        fused_host.count(tracker, "hit")
        return _replay_steady(tracker, m, cur, tables, ctx, spec["ext"], spec["f_cur"],
                              spec["readback"], spec["chain"])

    # the image upload first: it travels while the host builds the tables
    img_d = fused_host._upload(tracker, np.asarray(cur.image, np.float32))
    ctx = _ensure_ctx(tracker, m, tables)
    tracker.update_last_frame()
    T_init = (tracker.velocity @ tracker.last_frame.Tcw).astype(np.float32)
    cur.keypoint_map.clear()

    f_prev, _ = m._features(tracker.last_frame)
    prev_cellrow, ext = _prev_cellrow(tracker, ctx, tables)
    f_cur, out, union_row, T2 = steady_step_loftr(
        img_d, m.model, f_prev,
        fused_host._upload(tracker, prev_cellrow),
        fused_host._mp_pos_for(tracker, ctx, ext),
        fused_host._upload(tracker, T_init),
        ctx["kf_feats"], ctx["kf_cellrow"], ctx["first_slot_d"], ctx["normal_d"],
        ctx["maxdist_d"], tables["uv"], fused_host._k_dev(tracker),
        _info_val(tracker, m, tables), float(m.threshold),
        float(tracker.img_width), float(tracker.img_height),
    )
    return _replay_steady(tracker, m, cur, tables, ctx, ext, f_cur,
                          fused_tracking.HostCopy(loftr_fields(out)), (union_row, T2))


def _replay_steady(tracker, m, cur, tables, ctx, ext, f_cur, readback, chain) -> bool | None:
    """Readback + full host replay of a LoFTR steady step (shared by the
    direct and speculative-dispatch paths). `readback` is the step's
    fused_tracking.HostCopy of `loftr_fields`."""
    nrows = ctx["rcap"]
    # seed the matcher cache so later stages reuse the encode
    m.seed_cache(cur, f_cur, tables["scale"])

    # THE one readback of the frame
    h = fused_host._land(tracker, readback)
    T1 = h["T1"]
    n_matches = int(h["n_matches"])
    row = h["row"].astype(np.int64)
    okm = h["okm"]
    inlier1 = h["inlier1"]
    j1 = h["j1"].astype(np.int64)
    T2 = h["T2"]
    new_row = h["new_row"].astype(np.int64)
    inlier2 = h["inlier2"]
    vis = h["vis"]

    # match image from the raw cell matches (CreateCurrentMatchImage, B6)
    uv_host = tables["uv_host"]
    res = MatchFramesResult(
        frame1=cur,
        frame2=tracker.last_frame,
        keypoints1=uv_host[okm].astype(np.int32),
        keypoints2=uv_host[j1[okm]].astype(np.int32),
    )
    tracker.create_current_match_image(res, has_mp=(row >= 0)[okm])

    if n_matches < tracker.min_local_match_count:
        fused_host.count(tracker, "fallback_raw_matches")
        tracker._loftr_chain = None
        return None  # too few raw matches -> host reference-keyframe path

    def mp_of_row(r: int):
        return ctx["mps"][r] if r < nrows else ext[r - nrows]

    info_v = _info_val(tracker, m, tables)
    pix_tab = tables["pix"]

    # motion association replay
    keep = row >= 0
    inl_c = np.nonzero(keep & inlier1)[0]
    for c in np.nonzero(keep & ~inlier1)[0]:
        mp_of_row(row[c]).last_frame_seen = cur.id
    mps_in = [mp_of_row(r) for r in row[inl_c]]
    cur.keypoint_map.bulk_set_map_points(
        [int(pix_tab[c]) for c in inl_c],
        mps_in,
        [tuple(uv_host[c]) for c in inl_c],
        [info_v] * len(inl_c),
    )
    cell_of_pixel = {int(pix_tab[c]): int(c) for c in inl_c}
    n_matches_map = sum(1 for mp in mps_in if mp.n_obs > 0)
    cur.set_pose(T1)

    if n_matches_map < 10:
        fused_host.count(tracker, "fallback_motion")
        tracker._loftr_chain = None
        return None  # motion model failed -> host reference-keyframe path

    # visible/seen bookkeeping (Tracking.cc:577-588)
    to_remove = []
    for idx, item in cur.keypoint_map.items():
        mp = item.map_point
        if mp.is_bad:
            to_remove.append(idx)
        else:
            mp.increase_visible()
            mp.last_frame_seen = cur.id
    for idx in to_remove:
        cur.keypoint_map.set_map_point_by_index(idx, None)
    cell_of_pixel = {
        pix: c for pix, c in cell_of_pixel.items() if pix in cur.keypoint_map._items
    }

    # candidate marker parity + frustum-visible counters (Tracking.cc:589-616)
    for mp in ctx["mps"]:
        mp.track_reference_for_frame = cur.id
    for r in np.nonzero(vis[:nrows])[0]:
        ctx["mps"][r].increase_visible()

    # new associations (first-keyframe-wins resolved on the device)
    ns = np.nonzero(new_row >= 0)[0]
    cur.keypoint_map.bulk_set_map_points(
        [int(pix_tab[c]) for c in ns],
        [ctx["mps"][r] for r in new_row[ns]],
        [tuple(uv_host[c]) for c in ns],
        [info_v] * len(ns),
    )
    cell_of_pixel.update((int(pix_tab[c]), int(c)) for c in ns)

    cur.set_pose(T2)

    # final inlier accounting (TrackLocalMap, Tracking.cc:497-516)
    tracker.n_matches_inliers = 0
    for pix, c in cell_of_pixel.items():
        item = cur.keypoint_map._items.get(pix)
        if item is None:
            continue
        item.outlier = not bool(inlier2[c])
        if not item.outlier:
            item.map_point.increase_found()
            if item.map_point.n_obs > 0:
                tracker.n_matches_inliers += 1

    # refresh the (one-frame-stale) window + reference keyframe
    tracker.update_local_keyframes()

    # device-resident chain for the NEXT frame's speculative dispatch: this
    # frame's final per-cell association table + pose stay on the device
    ok_final = tracker.n_matches_inliers >= tracker.min_local_match_count
    if ok_final:
        tracker._loftr_chain = {
            "frame_id": cur.id,
            "ctx": ctx,
            "ext": ext,
            "chain": chain,  # (cellrow_d, T2_d)
            "T_prev_host": np.array(tracker.last_frame.Tcw, np.float32),
        }
    else:
        tracker._loftr_chain = None

    coeff = tracker.n_matches_inliers / max(tracker.min_local_match_count, 1)
    tracker._log(f"Tracking coefficient - {coeff}, if < 1.0 then tracking will be lost.")
    return ok_final


# ---------------------------------------------------------------------------
# speculative dispatch (pipelined mode)


def prepare_spec_inputs(tracker, image) -> dict | None:
    """Build (without dispatching) the device inputs of a speculative LoFTR
    steady step from the tracker's device-resident chain, sharing
    fused_host's counters. Returns None when the chain preconditions fail;
    mutates no tracking state. As fused_host.prepare_spec_inputs, it gives
    `kind`, `statics`, `T_prev_host` and the server's grouping `key` (the
    statics, the shared information weight and the image shape)."""
    m = tracker.matcher
    ch = getattr(tracker, "_loftr_chain", None)
    if (
        ch is None
        or not getattr(tracker.params, "fusedOneStep", False)
        or not isinstance(m, lm.LoftrFeatureMatcher)
        or m.fine
        or tracker.last_frame is None
        or ch["frame_id"] != tracker.last_frame.id
        or tracker.velocity is None
        or not tracker.local_keyframes
    ):
        fused_host.count(tracker, "skip_no_chain")
        return None
    tables = _cell_tables(tracker)
    ctx = _ensure_ctx(tracker, m, tables)
    if ctx is not ch["ctx"]:
        fused_host.count(tracker, "skip_ctx_changed")
        return None  # window/geometry changed; chain rows are stale
    ext = ch["ext"]
    cellrow_d, T2_d = ch["chain"]
    img = np.asarray(image, np.float32)
    h, w = img.shape
    statics = {
        "threshold": float(m.threshold),
        "width": float(tracker.img_width),
        "height": float(tracker.img_height),
        "resize_hw": None if (h, w) == (lm.MODEL_H, lm.MODEL_W) else (lm.MODEL_H, lm.MODEL_W),
    }
    info_val = _info_val(tracker, m, tables)
    return {
        "kind": "loftr",
        "img_d": fused_host._upload(tracker, img),
        "f_prev": m._features(tracker.last_frame)[0],
        "cellrow_d": cellrow_d,
        "T2_d": T2_d,
        "T_prev_host": np.asarray(ch["T_prev_host"], np.float32),
        "mp_pos_d": fused_host._mp_pos_for(tracker, ctx, ext),
        "info_val": info_val,
        "tables": tables,
        "ctx": ctx,
        "ext": ext,
        "statics": statics,
        "key": ("loftr", tuple(sorted(statics.items())), info_val, img.shape),
    }


def finish_spec(tracker, prep, f_cur, readback, chain) -> dict:
    """Package a dispatched LoFTR steady step as the spec that run_steady's
    speculative branch consumes; `readback` (a started HostCopy, or one
    stream's row of a server group's shared copy) lands while the caller
    works on the next frame."""
    return {
        "kind": "loftr",
        "prev_frame_id": tracker.last_frame.id,
        "ctx": prep["ctx"],
        "ext": prep["ext"],
        "f_cur": f_cur,
        "readback": readback,
        "chain": chain,
    }


def dispatch_prepared(tracker, prep) -> dict:
    """Dispatch a speculative LoFTR steady step from a prepared input set
    (`prepare_spec_inputs`)."""
    fused_host.count(tracker, "dispatch")
    m = tracker.matcher
    ctx = prep["ctx"]
    f_cur, out, union_row, T2 = steady_step_loftr(
        prep["img_d"], m.model, prep["f_prev"], prep["cellrow_d"], prep["mp_pos_d"],
        fused_tracking.chain_T_init(prep["T2_d"],
                                    fused_host._upload(tracker, prep["T_prev_host"])),
        ctx["kf_feats"], ctx["kf_cellrow"], ctx["first_slot_d"], ctx["normal_d"],
        ctx["maxdist_d"], prep["tables"]["uv"], fused_host._k_dev(tracker),
        prep["info_val"], float(m.threshold),
        float(tracker.img_width), float(tracker.img_height),
    )
    return finish_spec(tracker, prep, f_cur,
                       fused_tracking.HostCopy(loftr_fields(out)), (union_row, T2))


def dispatch_steady_spec(tracker, image) -> dict | None:
    """Speculatively dispatch the NEXT frame's LoFTR steady step from the
    last completed frame's device-resident chain (the LoFTR twin of
    fused_host.dispatch_steady_spec, which routes here)."""
    prep = prepare_spec_inputs(tracker, image)
    if prep is None:
        return None
    return dispatch_prepared(tracker, prep)
