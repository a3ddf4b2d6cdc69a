"""Host side of the fused steady-state tracking paths.

PyTorch counterpart of `mono_slam_framework_tpu/slam/fused_host.py`.
Orchestrates slam/fused_tracking.py's device calls (`run`: motion step and
local step, two readbacks; `run_steady`: one steady step, ONE readback) and
replays their association tables into the host map model with the
semantics of the unfused path (tracking.py::track_with_motion_model +
track_local_map). Returns None whenever a fused precondition fails, and the
caller falls back: `run_steady` -> `run` -> the reference-twin host path,
all on the tracker's device.

Per-frame host work is kept small by a keyed device context (`_ensure_ctx`):
the stacked local-keyframe features, association tables and geometry stay
on the device between keyframe events, invalidated by KeyPointMap version
counters (slam/frame.py) and the map's geometry epoch (slam/map_model.py).

Each table is passed at its own size, without the JAX package's shape
ladders or capacity floors: the ctx row space has `nrows` rows (`rcap` is
`nrows`), extension rows start at `nrows`, there are `n_kf` keyframe slots,
and `kf_px` / `kf_row` are padded with -1 only to the longest keyframe's
item count. Host arrays reach the device through pinned staging tensors
with non-blocking copies, so an upload never waits for queued device work;
the staging tensors stay referenced until the frame's readback has landed.
"""

from __future__ import annotations

import numpy as np
import torch

from mono_slam_framework_torch.matchers.base import MatchFramesResult
from mono_slam_framework_torch.matchers.loftr_matcher import LoftrFeatureMatcher
from mono_slam_framework_torch.matchers.orb_matcher import OrbFeatureMatcher
from mono_slam_framework_torch.ops import orb
from mono_slam_framework_torch.slam import fused_tracking


def pipe_stats(tracker) -> dict:
    """Counters of the fused flow (created lazily). As in the JAX package:
    `dispatch` = speculative programs fired ahead of time, `hit` = consumed,
    `miss_*` = invalidated between dispatch and consumption or failed the
    inlier floor, `skip_*` = why no dispatch happened after a frame. Added
    here: `done_*` = frames completed by run_steady / run / the host path,
    `fallback_*` / `run_fallback_*` = why run_steady / run returned None,
    `ctx_builds` = local-map contexts built, `loftr_graph_replay` /
    `loftr_graph_capture` / `loftr_eager` = the fused LoFTR step's model
    calls by how they ran (models/loftr_native.GraphCache). The pipelined
    mode adds `process_samples_ms` / `dispatch_samples_ms` (slam/system.py)."""
    s = getattr(tracker, "_pipe_stats", None)
    if s is None:
        s = {"dispatch": 0, "hit": 0}
        tracker._pipe_stats = s
    return s


def count(tracker, key: str) -> None:
    """Add one to pipe_stats(tracker)[key]."""
    s = pipe_stats(tracker)
    s[key] = s.get(key, 0) + 1


def applicable(tracker) -> bool:
    """Fused path preconditions: steady OK-state motion-model tracking with
    the ORB matcher (a DNN matcher has no slot-feature contract)."""
    return (
        getattr(tracker.params, "fusedTracking", False)
        and isinstance(tracker.matcher, OrbFeatureMatcher)
        and tracker.velocity is not None
        and tracker.current_frame.id >= tracker.last_reloc_frame_id + 2
    )


def _row_tables(mp_lists):
    """Assign a dense row per unique MapPoint across the given lists; returns
    (row_of: dict id(mp)->row, mps: list ordered by row)."""
    row_of: dict = {}
    mps: list = []
    for lst in mp_lists:
        for mp in lst:
            key = id(mp)
            if key not in row_of:
                row_of[key] = len(mps)
                mps.append(mp)
    return row_of, mps


def _upload(tracker, a) -> torch.Tensor:
    """A host array on the tracker's device, without a synchronization: on
    a card through a pinned staging tensor and a non-blocking copy (the
    staging tensor is kept in `tracker._fused_staging` until the next
    readback has landed, which orders it after the copy)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if tracker.device.type != "cuda":
        return t.to(tracker.device, copy=True)
    pinned = t.pin_memory()
    staging = getattr(tracker, "_fused_staging", None)
    if staging is None:
        staging = tracker._fused_staging = []
    staging.append(pinned)
    return pinned.to(tracker.device, non_blocking=True)


def _land(tracker, readback: fused_tracking.HostCopy) -> dict:
    """Wait for a readback and release the staging tensors queued before it."""
    h = readback.wait()
    staging = getattr(tracker, "_fused_staging", None)
    if staging:
        staging.clear()
    return h


def _k_dev(tracker):
    """Device-resident intrinsics (uploaded once per tracker)."""
    k = getattr(tracker, "_fused_K_dev", None)
    if k is None:
        k = _upload(tracker, np.asarray(tracker.K, np.float32))
        tracker._fused_K_dev = k
    return k


def _prev_tables(n: int):
    """(prev_px, prev_row) host arrays of n entries, -1 filled; at least one
    entry so that the association's argmax has something to reduce."""
    return np.full(max(n, 1), -1, np.int32), np.full(max(n, 1), -1, np.int32)


def _ensure_ctx(tracker, m) -> dict:
    """Local-map device context: stacked keyframe features + association
    tables + the keyframe-side row space + geometry tables. Rebuilt only
    when the local-keyframe set, any member's KeyPointMap version, or the
    map's geometry epoch changes (or a cached point turned bad): between
    keyframe events it is static, so steady frames skip both the host table
    walk and the device-side feature re-stack."""
    # canonical (id-sorted) slot order: update_local_keyframes rebuilds its
    # list in vote order, which shuffles frame to frame even when the SET is
    # unchanged; sorting keeps the cache key stable. Slot order only
    # tie-breaks which keyframe proposes a shared pixel.
    local_kfs = sorted(tracker.local_keyframes, key=lambda kf: kf.id)
    n_kf = len(local_kfs)
    ckey = (
        tuple(kf.id for kf in local_kfs),
        tuple(kf.keypoint_map.version for kf in local_kfs),
        tracker.map.geometry_epoch,
    )
    ctx = getattr(tracker, "_fused_lm_ctx", None)
    if ctx is not None and ctx["key"] == ckey and not any(
        mp.is_bad for mp in ctx["mps"]
    ):
        return ctx
    count(tracker, "ctx_builds")

    kf_items = [
        [
            (idx, it)
            for idx, it in kf.keypoint_map.items()
            if it.map_point is not None and not it.map_point.is_bad
        ]
        for kf in local_kfs
    ]
    row_of, mps = _row_tables([[it.map_point for _, it in items] for items in kf_items])
    # first keyframe slot proposing each row, in (kf, item) walk order: the
    # cross-keyframe dedup marker's winner (Tracking.cc:589-599)
    first_slot = np.full(len(mps), -1, np.int32)
    for kslot in range(n_kf - 1, -1, -1):
        for _, it in kf_items[kslot]:
            first_slot[row_of[id(it.map_point)]] = kslot
    m2 = max(max((len(i) for i in kf_items), default=0), 1)
    kf_px = np.full((n_kf, m2), -1, np.int32)
    kf_row = np.full((n_kf, m2), -1, np.int32)
    for kslot, items in enumerate(kf_items):
        for i, (idx, it) in enumerate(items):
            kf_px[kslot, i] = idx
            kf_row[kslot, i] = row_of[id(it.map_point)]
    stack_key = tuple(kf.id for kf in local_kfs)
    stack_cache = getattr(tracker, "_fused_stack_cache", None)
    if stack_cache is not None and stack_cache[0] == stack_key:
        kf_feats = stack_cache[1]
    else:
        kf_feats = orb.Features(
            *(torch.stack(xs) for xs in zip(*(m.features_for(kf) for kf in local_kfs)))
        )
        tracker._fused_stack_cache = (stack_key, kf_feats)
    # geometry tables over the row space, static until geometry_epoch moves
    # (position/normal writes bump it, map_model.py)
    nrows = len(mps)
    pos = np.zeros((nrows, 3), np.float32)
    nrm = np.zeros((nrows, 3), np.float32)
    maxd = np.zeros(nrows, np.float32)
    for r, mp in enumerate(mps):
        pos[r] = mp.world_pos
        nrm[r] = mp.normal
        maxd[r] = mp.distance_invariance()
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
        "kf_px": _upload(tracker, kf_px),
        "kf_row": _upload(tracker, kf_row),
        "kf_feats": kf_feats,
        "first_slot_d": _upload(tracker, first_slot),
        "normal_d": _upload(tracker, nrm),
        "maxdist_d": _upload(tracker, maxd),
        # steady frames without extension rows reuse this table instead of
        # rebuilding and uploading mp_pos every frame
        "mp_pos_d": _upload(tracker, pos_dev),
    }
    tracker._fused_lm_ctx = ctx
    return ctx


def _match_image(tracker, cur, prev_feats, h) -> None:
    """Match image from the raw matches (CreateCurrentMatchImage, quirk B6),
    rendered lazily. The last frame's xy came back in ITS readback: reuse the
    host copy instead of reading prev_feats.xy from the device."""
    cached = getattr(tracker, "_fused_prev_xy", None)
    if cached is not None and cached[0] == tracker.last_frame.id:
        prev_xy_host = cached[1]
    else:
        count(tracker, "prev_xy_reads")
        prev_xy_host = prev_feats.xy.cpu().numpy()
    cur_xy_f = h["xy"]
    tracker._fused_prev_xy = (cur.id, cur_xy_f)
    okm = h["ok"]
    res = MatchFramesResult(
        frame1=cur,
        frame2=tracker.last_frame,
        keypoints1=cur_xy_f.astype(np.int32)[okm],
        keypoints2=prev_xy_host[h["idx2"]][okm].astype(np.int32),
    )
    # has_mp per match straight from the device association (row >= 0
    # before dedup): skips N get_map_point dict lookups in the renderer
    tracker.create_current_match_image(res, has_mp=(h["row"] >= 0)[okm])


def run(tracker) -> bool | None:
    """Run the fused motion + local steps. Returns the final tracking ok
    (True/False) or None when the caller must fall back to the host path."""
    m = tracker.matcher
    cur = tracker.current_frame
    cols = cur.keypoint_map.cols

    # ---- motion step -----------------------------------------------------
    img_d = _upload(tracker, np.asarray(cur.image, np.float32))
    tracker.update_last_frame()
    T_init = (tracker.velocity @ tracker.last_frame.Tcw).astype(np.float32)
    cur.keypoint_map.clear()

    prev_feats = m.features_for(tracker.last_frame)
    prev_items = [
        (idx, it)
        for idx, it in tracker.last_frame.keypoint_map.items()
        if it.map_point is not None
    ]
    row_of, mps1 = _row_tables([[it.map_point for _, it in prev_items]])
    prev_px, prev_row = _prev_tables(len(prev_items))
    for i, (idx, it) in enumerate(prev_items):
        prev_px[i] = idx
        prev_row[i] = row_of[id(it.map_point)]
    mp_pos1 = np.zeros((max(len(mps1), 1), 3), np.float32)
    for r, mp in enumerate(mps1):
        mp_pos1[r] = mp.world_pos

    feats, motion = fused_tracking.motion_step(
        img_d, prev_feats, _upload(tracker, prev_px), _upload(tracker, prev_row),
        _upload(tracker, mp_pos1), _upload(tracker, T_init), _k_dev(tracker),
        float(m.threshold), int(cols), bool(tracker.octave_information),
        m.max_features, m.fast_threshold,
    )
    # seed the matcher cache so later stages (keyframe creation, local
    # mapping) reuse the device features without extracting again
    m.seed_cache(cur, feats)

    h = _land(tracker, fused_tracking.HostCopy(fused_tracking.motion_fields(feats, motion)))
    T1 = h["T1"]
    n_matches = int(h["n_matches"])
    row = h["row"].astype(np.int32)
    keep, inlier = h["keep"], h["inlier"]
    cur_xy_f = h["xy"]
    cur_oct = h["octave"].astype(np.int32)
    cur_xy_i = cur_xy_f.astype(np.int32)
    _match_image(tracker, cur, prev_feats, h)

    if n_matches < tracker.min_local_match_count:
        count(tracker, "run_fallback_raw_matches")
        return None  # too few raw matches -> host reference-keyframe path

    info_of = (
        (lambda o: float(1.2 ** (-2.0 * o)))
        if tracker.octave_information
        else (lambda o: 1.0)
    )
    # replay associations (last-writer-wins already resolved on the device):
    # inliers populate the keypoint map; outliers only stamp last_frame_seen
    slot_of_pixel: dict[int, int] = {}
    n_matches_map = 0
    for s in np.nonzero(keep)[0]:
        mp = mps1[row[s]]
        if inlier[s]:
            px = (int(cur_xy_i[s, 0]), int(cur_xy_i[s, 1]))
            cur.keypoint_map.set_map_point(
                px, mp,
                measurement=(float(cur_xy_f[s, 0]), float(cur_xy_f[s, 1])),
                info=info_of(int(cur_oct[s])),
            )
            slot_of_pixel[cur.keypoint_map.index_of(px)] = int(s)
            if mp.n_obs > 0:
                n_matches_map += 1
        else:
            mp.last_frame_seen = cur.id
    cur.set_pose(T1)

    if n_matches_map < 10:
        count(tracker, "run_fallback_motion")
        return None  # motion model failed -> host reference-keyframe path

    # ---- local-map step --------------------------------------------------
    tracker.update_local_keyframes()

    # visible/seen bookkeeping for already-associated points
    # (SearchLocalPoints first loop, Tracking.cc:577-588)
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
    # update_local_keyframes / the loop above may have dropped entries
    slot_of_pixel = {
        pix: s for pix, s in slot_of_pixel.items() if pix in cur.keypoint_map._items
    }

    if not tracker.local_keyframes:
        count(tracker, "run_fallback_no_window")
        return None

    ctx = _ensure_ctx(tracker, m)
    nrows = ctx["rcap"]

    # candidate mask over the cached ctx row space
    cand_mask = np.zeros(nrows, bool)
    for r, mp in enumerate(ctx["mps"]):
        mp.track_reference_for_frame = cur.id
        if mp.last_frame_seen != cur.id:
            cand_mask[r] = True

    # extend the row space past nrows with current-frame associations the
    # keyframe tables do not cover (points whose observers left the window)
    ext: list = []
    ext_rows: dict = {}

    def row_of_mp(mp):
        r = ctx["row_of"].get(id(mp))
        if r is not None:
            return r
        r = ext_rows.get(id(mp))
        if r is None:
            r = nrows + len(ext)
            ext_rows[id(mp)] = r
            ext.append(mp)
        return r

    k_slots = cur_xy_f.shape[0]
    cur_row = np.full(k_slots, -1, np.int32)
    for pix, s in slot_of_pixel.items():
        cur_row[s] = row_of_mp(cur.keypoint_map._items[pix].map_point)

    local = fused_tracking.local_step(
        feats,
        _upload(tracker, cur_row),
        motion.T1,
        ctx["kf_feats"],
        ctx["kf_px"],
        ctx["kf_row"],
        _upload(tracker, cand_mask),
        ctx["first_slot_d"],
        ctx["normal_d"],
        ctx["maxdist_d"],
        _mp_pos_for(tracker, ctx, ext),
        motion.T1,
        _k_dev(tracker),
        float(m.threshold),
        int(cols),
        float(tracker.img_width),
        float(tracker.img_height),
        bool(tracker.octave_information),
    )
    h2 = _land(tracker, fused_tracking.HostCopy(fused_tracking.local_fields(local)))
    T2 = h2["T2"]
    new_row = h2["new_row"].astype(np.int32)
    inlier2 = h2["inlier2"]
    vis = h2["vis"]

    # frustum-visible candidates observed (Tracking.cc:612-616)
    for r in np.nonzero(vis[:nrows])[0]:
        ctx["mps"][r].increase_visible()

    def mp_of_row(r: int):
        return ctx["mps"][r] if r < nrows else ext[r - nrows]

    # replay new associations (first-wins already resolved on the device)
    for s in np.nonzero(new_row >= 0)[0]:
        mp = mp_of_row(new_row[s])
        px = (int(cur_xy_i[s, 0]), int(cur_xy_i[s, 1]))
        cur.keypoint_map.set_map_point(
            px, mp,
            measurement=(float(cur_xy_f[s, 0]), float(cur_xy_f[s, 1])),
            info=info_of(int(cur_oct[s])),
        )
        slot_of_pixel[cur.keypoint_map.index_of(px)] = int(s)

    cur.set_pose(T2)

    # final inlier accounting (TrackLocalMap, Tracking.cc:497-516)
    tracker.n_matches_inliers = 0
    for pix, s in slot_of_pixel.items():
        item = cur.keypoint_map._items.get(pix)
        if item is None:
            continue
        item.outlier = not bool(inlier2[s])
        if not item.outlier:
            item.map_point.increase_found()
            if item.map_point.n_obs > 0:
                tracker.n_matches_inliers += 1

    coeff = tracker.n_matches_inliers / max(tracker.min_local_match_count, 1)
    tracker._log(
        f"Tracking coefficient - {coeff}, if < 1.0 then tracking will be lost."
    )
    return tracker.n_matches_inliers >= tracker.min_local_match_count


def _mp_pos_for(tracker, ctx, ext):
    """Position table for a dispatch: ctx rows up front, extension rows from
    `rcap` (= nrows) on; the cached device table when there are none."""
    if not ext:
        return ctx["mp_pos_d"]
    nrows = ctx["rcap"]
    mp_pos = np.zeros((nrows + len(ext), 3), np.float32)
    mp_pos[:nrows] = ctx["pos"]
    for j, mp in enumerate(ext):
        mp_pos[nrows + j] = mp.world_pos
    return _upload(tracker, mp_pos)


def run_steady(tracker) -> bool | None:
    """One steady step per frame (`fusedOneStep`): motion + local-map
    tracking with a SINGLE readback. Uses the local-keyframe window computed
    after the previous frame (one frame stale; refreshed here after the
    readback, see fused_tracking.steady_step). Returns the final tracking ok,
    or None to fall back to the two-program / host paths."""
    m = tracker.matcher
    cur = tracker.current_frame
    cols = cur.keypoint_map.cols
    if not tracker.local_keyframes:
        count(tracker, "fallback_no_window")
        return None

    # speculative-dispatch consumption (track_monocular_pipelined): this
    # frame's steady step may already be queued, dispatched right after the
    # previous frame completed (dispatch_steady_spec). Valid only while
    # nothing touched the map state since: same ctx object, same last
    # frame, untouched clone.
    spec = getattr(tracker, "_pipe_spec", None)
    tracker._pipe_spec = None
    if spec is not None:
        ctx = _ensure_ctx(tracker, m)
        if spec["prev_frame_id"] != tracker.last_frame.id:
            count(tracker, "miss_frame")
            spec = None
        elif spec["ctx"] is not ctx:
            count(tracker, "miss_ctx")
            spec = None
        elif tracker.last_frame.keypoint_map.version != 0:
            count(tracker, "miss_version")
            spec = None
    if spec is not None:
        tracker.update_last_frame()
        cur.keypoint_map.clear()
        prev_feats = m.features_for(tracker.last_frame)
        count(tracker, "hit")
        return _replay_steady(
            tracker, m, cur, cols, ctx, spec["ext"], prev_feats, spec["feats"],
            spec["readback"], spec["chain"],
        )

    # the image upload first: the largest per-frame transfer, it travels
    # while the host builds the tables below
    img_d = _upload(tracker, np.asarray(cur.image, np.float32))
    ctx = _ensure_ctx(tracker, m)
    nrows = ctx["rcap"]

    tracker.update_last_frame()
    T_init = (tracker.velocity @ tracker.last_frame.Tcw).astype(np.float32)
    cur.keypoint_map.clear()

    prev_feats = m.features_for(tracker.last_frame)
    # prev associations in the ctx row space; points outside the window get
    # extension rows from nrows on (their positions ride the mp_pos upload).
    # Fast path: the previous steady frame saved its final association
    # arrays, valid while the clone's KeyPointMap and the ctx are untouched.
    ext: list = []
    saved = getattr(tracker, "_fused_prev_assoc", None)
    if (
        saved is not None
        and saved["frame_id"] == tracker.last_frame.id
        and saved["ctx"] is ctx
        and saved["version"] == tracker.last_frame.keypoint_map.version
    ):
        # saved rows: >= 0 are ctx rows; negative encode extension points
        # as -(ext_index + 1) into saved["ext"]
        px_arr, row_arr = saved["px"], saved["row"]
        ext = list(saved["ext"])
        prev_px, prev_row = _prev_tables(px_arr.shape[0])
        prev_px[: px_arr.shape[0]] = px_arr
        prev_row[: px_arr.shape[0]] = np.where(row_arr >= 0, row_arr, nrows - 1 - row_arr)
    else:
        prev_items = [
            (idx, it)
            for idx, it in tracker.last_frame.keypoint_map.items()
            if it.map_point is not None
        ]
        ext_rows: dict = {}
        prev_px, prev_row = _prev_tables(len(prev_items))
        for i, (idx, it) in enumerate(prev_items):
            mp = it.map_point
            r = ctx["row_of"].get(id(mp))
            if r is None:
                r = ext_rows.get(id(mp))
                if r is None:
                    r = nrows + len(ext)
                    ext_rows[id(mp)] = r
                    ext.append(mp)
            prev_px[i] = idx
            prev_row[i] = r

    out = fused_tracking.steady_step(
        img_d,
        prev_feats,
        _upload(tracker, prev_px),
        _upload(tracker, prev_row),
        _mp_pos_for(tracker, ctx, ext),
        _upload(tracker, T_init),
        ctx["kf_feats"],
        ctx["kf_px"],
        ctx["kf_row"],
        ctx["first_slot_d"],
        ctx["normal_d"],
        ctx["maxdist_d"],
        _k_dev(tracker),
        float(m.threshold),
        int(cols),
        float(tracker.img_width),
        float(tracker.img_height),
        bool(tracker.octave_information),
        m.max_features,
        m.fast_threshold,
    )
    return _replay_steady(
        tracker, m, cur, cols, ctx, ext, prev_feats, out.cur,
        fused_tracking.HostCopy(fused_tracking.steady_fields(out)),
        (out.chain_px, out.union_row, out.local.T2),
    )


def _replay_steady(
    tracker, m, cur, cols, ctx, ext, prev_feats, feats, readback, chain,
):
    """Readback + full host replay of a steady step (shared by the direct
    and speculative-dispatch paths). `readback` is the step's
    fused_tracking.HostCopy of `steady_fields`."""
    m.seed_cache(cur, feats)

    # THE one readback of the frame
    h = _land(tracker, readback)
    nrows = ctx["rcap"]
    T1 = h["T1"]
    n_matches = int(h["n_matches"])
    row = h["row"].astype(np.int32)
    keep, inlier = h["keep"], h["inlier"]
    cur_xy_f = h["xy"]
    cur_oct = h["octave"].astype(np.int32)
    cur_xy_i = cur_xy_f.astype(np.int32)
    k_slots = cur_xy_f.shape[0]
    T2 = h["T2"]
    new_row = h["new_row"].astype(np.int32)
    inlier2 = h["inlier2"]
    vis = h["vis"]

    _match_image(tracker, cur, prev_feats, h)

    if n_matches < tracker.min_local_match_count:
        count(tracker, "fallback_raw_matches")
        tracker._fused_chain = None
        return None  # too few raw matches -> host reference-keyframe path

    # freshness gate (params.fusedInlierFloorShare): a degraded final inlier
    # count means the one-frame-stale window no longer covers the view —
    # discard and re-track through the host path, which rebuilds the window
    floor_share = getattr(tracker.params, "fusedInlierFloorShare", 0.0)
    if floor_share > 0.0:
        floor = max(
            tracker.min_local_match_count,
            int(floor_share * getattr(m, "max_features", 0)),
        )
        if int(np.count_nonzero(inlier2)) < floor:
            count(tracker, "miss_quality")
            tracker._fused_chain = None
            return None

    def mp_of_row(r: int):
        return ctx["mps"][r] if r < nrows else ext[r - nrows]

    info_arr = (
        (1.2 ** (-2.0 * cur_oct.astype(np.float64)))
        if tracker.octave_information
        else np.ones(k_slots)
    )
    # motion association replay (last-writer-wins and bounds already
    # resolved on the device; pixel indices computed vectorized)
    kept = np.nonzero(keep)[0]
    inl_s = kept[inlier[kept]]
    for s in kept[~inlier[kept]]:
        mp_of_row(row[s]).last_frame_seen = cur.id
    idxs = (cur_xy_i[inl_s, 1] * cols + cur_xy_i[inl_s, 0]).tolist()
    mps_in = [mp_of_row(r) for r in row[inl_s]]
    cur.keypoint_map.bulk_set_map_points(
        idxs,
        mps_in,
        list(zip(cur_xy_f[inl_s, 0].tolist(), cur_xy_f[inl_s, 1].tolist())),
        info_arr[inl_s].tolist(),
    )
    slot_of_pixel: dict[int, int] = dict(zip(idxs, inl_s.tolist()))
    n_matches_map = sum(1 for mp in mps_in if mp.n_obs > 0)
    cur.set_pose(T1)

    if n_matches_map < 10:
        count(tracker, "fallback_motion")
        tracker._fused_chain = None
        return None  # motion model failed -> host reference-keyframe path

    # visible/seen bookkeeping for associated points (Tracking.cc:577-588)
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
    slot_of_pixel = {
        pix: s for pix, s in slot_of_pixel.items() if pix in cur.keypoint_map._items
    }

    # candidate marker parity + frustum-visible counters (Tracking.cc:589-616)
    for mp in ctx["mps"]:
        mp.track_reference_for_frame = cur.id
    for r in np.nonzero(vis[:nrows])[0]:
        ctx["mps"][r].increase_visible()

    # replay new associations (first-wins resolved on the device; rows are
    # always ctx rows: only the keyframe tables propose)
    ns = np.nonzero(new_row >= 0)[0]
    idxs2 = (cur_xy_i[ns, 1] * cols + cur_xy_i[ns, 0]).tolist()
    cur.keypoint_map.bulk_set_map_points(
        idxs2,
        [ctx["mps"][r] for r in new_row[ns]],
        list(zip(cur_xy_f[ns, 0].tolist(), cur_xy_f[ns, 1].tolist())),
        info_arr[ns].tolist(),
    )
    slot_of_pixel.update(zip(idxs2, ns.tolist()))

    cur.set_pose(T2)

    # final inlier accounting (TrackLocalMap, Tracking.cc:497-516)
    tracker.n_matches_inliers = 0
    for pix, s in slot_of_pixel.items():
        item = cur.keypoint_map._items.get(pix)
        if item is None:
            continue
        item.outlier = not bool(inlier2[s])
        if not item.outlier:
            item.map_point.increase_found()
            if item.map_point.n_obs > 0:
                tracker.n_matches_inliers += 1

    # refresh the (one-frame-stale) window + reference keyframe for the
    # keyframe decision and the next frame's context
    tracker.update_local_keyframes()

    # save the final association arrays: the next steady frame rebuilds its
    # prev tables from them without walking the keypoint map (valid while
    # the cloned map and the ctx stay untouched)
    items = cur.keypoint_map._items
    pairs = [(pix, sl) for pix, sl in slot_of_pixel.items() if pix in items]
    if pairs:
        px_arr = np.asarray([pp for pp, _ in pairs], np.int32)
        s_arr = np.asarray([sl for _, sl in pairs], np.int64)
        rw = np.where(new_row[s_arr] >= 0, new_row[s_arr], row[s_arr])
        enc = np.where(rw >= nrows, -(rw - nrows) - 1, rw).astype(np.int32)
        tracker._fused_prev_assoc = {
            "frame_id": cur.id,
            "ctx": ctx,
            "version": 0,  # the clone's KeyPointMap starts at version 0
            "px": px_arr,
            "row": enc,
            "ext": ext,
        }
    else:
        tracker._fused_prev_assoc = None

    # device-resident chain for the NEXT frame's speculative dispatch: this
    # frame's final associations + pose stay on the device; the previous
    # frame's (re-anchored) pose rides along for the velocity model
    ok_final = tracker.n_matches_inliers >= tracker.min_local_match_count
    if ok_final:
        tracker._fused_chain = {
            "frame_id": cur.id,
            # the chain's row values live in THIS ctx's row space (+ ext
            # offsets from nrows); a dispatch may only consume them under
            # the identical ctx object
            "ctx": ctx,
            "ext": ext,
            "chain": chain,
            "T_prev_host": np.array(tracker.last_frame.Tcw, np.float32),
        }
    else:
        tracker._fused_chain = None

    coeff = tracker.n_matches_inliers / max(tracker.min_local_match_count, 1)
    tracker._log(
        f"Tracking coefficient - {coeff}, if < 1.0 then tracking will be lost."
    )
    return ok_final


def prepare_spec_inputs(tracker, image) -> dict | None:
    """Build (without dispatching) the device inputs of a speculative steady
    step from the tracker's device-resident chain state. Returns None when
    the chain preconditions fail; mutates no tracking state, so a prepared
    frame can still fall back to the fresh-dispatch path.

    Shared by `dispatch_steady_spec` (one stream, pipelined mode) and
    `parallel.server.SlamServer`, which stacks several trackers' prepared
    inputs into one `multistream.steady_step_batch` call: `kind` names the
    step, `statics` its static arguments, `T_prev_host` the previous pose
    for the batched `chain_T_init`, and `key` groups the frames that can
    share a batched call (the statics and the image shape; the tables are
    padded to common sizes at dispatch)."""
    m = tracker.matcher
    ch = getattr(tracker, "_fused_chain", None)
    if (
        ch is None
        or not getattr(tracker.params, "fusedOneStep", False)
        or not isinstance(m, OrbFeatureMatcher)
        or tracker.last_frame is None
        or ch["frame_id"] != tracker.last_frame.id
        or tracker.velocity is None
        or not tracker.local_keyframes
    ):
        count(tracker, "skip_no_chain")
        return None
    ctx = _ensure_ctx(tracker, m)
    if ctx is not ch["ctx"]:
        count(tracker, "skip_ctx_changed")
        return None  # window/geometry changed; chain rows are stale
    ext = ch["ext"]
    chain_px_d, chain_row_d, T2_d = ch["chain"]
    img = np.asarray(image, np.float32)
    # the static arguments of the steady step (the JAX package's statics)
    statics = {
        "ratio": float(m.threshold),
        "cols": int(tracker.last_frame.keypoint_map.cols),
        "width": float(tracker.img_width),
        "height": float(tracker.img_height),
        "use_octave_info": bool(tracker.octave_information),
        "max_features": int(m.max_features),
        "fast_threshold": float(m.fast_threshold),
    }
    return {
        "kind": "orb",
        "img_d": _upload(tracker, img),
        "prev_feats": m.features_for(tracker.last_frame),
        "chain_px_d": chain_px_d,
        "chain_row_d": chain_row_d,
        "T2_d": T2_d,
        "T_prev_host": np.asarray(ch["T_prev_host"], np.float32),
        "mp_pos_d": _mp_pos_for(tracker, ctx, ext),
        "ctx": ctx,
        "ext": ext,
        "statics": statics,
        "key": ("orb", tuple(sorted(statics.items())), img.shape),
    }


def finish_spec(tracker, prep, feats, readback, chain) -> dict:
    """Package a dispatched steady step as the spec that run_steady's
    speculative branch consumes. `readback` (a started HostCopy, or one
    stream's row of a server group's shared copy: anything whose `wait()`
    gives the `steady_fields` as numpy) lands while the caller works on the
    next frame; the spec holds the device tensors until run_steady consumes
    or drops it."""
    return {
        "kind": "orb",
        "prev_frame_id": tracker.last_frame.id,
        "ctx": prep["ctx"],
        "ext": prep["ext"],
        "feats": feats,
        "readback": readback,
        "chain": chain,
    }


def dispatch_steady_spec(tracker, image) -> dict | None:
    """Speculatively dispatch the NEXT frame's steady step from the last
    completed frame's device-resident chain state
    (track_monocular_pipelined).

    Called right after a frame finishes, with the next image in hand: the
    device work and its device->host copy run while the caller produces the
    following frame. The consumption side (run_steady's spec branch)
    re-validates that nothing touched the map state in between and falls
    back to a fresh dispatch otherwise. Queues work without synchronizing.
    A LoFTR matcher's step is dispatched by its twin,
    fused_loftr.dispatch_steady_spec, as in the JAX package.
    """
    if isinstance(tracker.matcher, LoftrFeatureMatcher):
        from mono_slam_framework_torch.slam import fused_loftr

        return fused_loftr.dispatch_steady_spec(tracker, image)
    prep = prepare_spec_inputs(tracker, image)
    if prep is None:
        return None
    return dispatch_prepared(tracker, prep)


def dispatch_prepared(tracker, prep) -> dict:
    """Dispatch a speculative steady step from a prepared input set
    (`prepare_spec_inputs`)."""
    count(tracker, "dispatch")
    ctx = prep["ctx"]
    out = fused_tracking.steady_step(
        prep["img_d"],
        prep["prev_feats"],
        prep["chain_px_d"],
        prep["chain_row_d"],
        prep["mp_pos_d"],
        fused_tracking.chain_T_init(prep["T2_d"], _upload(tracker, prep["T_prev_host"])),
        ctx["kf_feats"],
        ctx["kf_px"],
        ctx["kf_row"],
        ctx["first_slot_d"],
        ctx["normal_d"],
        ctx["maxdist_d"],
        _k_dev(tracker),
        **prep["statics"],
    )
    return finish_spec(
        tracker, prep, out.cur,
        fused_tracking.HostCopy(fused_tracking.steady_fields(out)),
        (out.chain_px, out.union_row, out.local.T2),
    )
