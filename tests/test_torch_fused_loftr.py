"""Port parity for the fused LoFTR flow's device step and host side
(slam/fused_loftr.py), on twin maps.

One numpy scene at 640x480: four local keyframes, a keyframe outside the
window and a last frame, with map points at back-projected cell corners,
each associated in every frame at the cell its projection falls in (the
LoFTR decode's pixel), built with each package's classes. Every frame's
LoFTR features come from one port encode on the CPU and are handed to both
packages as the same numpy arrays.

  * `_cell_tables` and the `_ensure_ctx` tables equal the JAX package's
    (the port's are the unpadded prefix of the JAX ladder / pow2 tables);
  * `_loftr_core` equals the JAX `_loftr_core(use_pallas_lm=False)`: every
    integer output (n_matches, n_good, j1, okm, the inlier masks, vis, and
    the association rows as map-point ids) equal, T1 and T2 within atol 1e-4
    (tests/test_torch_slice.py's bound for the pose LMs' f32 sums);
  * `_replay_steady` on that step's outputs leaves both maps, frames and
    trackers in the same state (associations with measurements and
    weights, point counters, inliers, pose, window, chain), and both return
    None at the raw-match and motion gates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_parity  # noqa: F401  (pins torch to one thread)
from mono_slam_framework_tpu.models import loftr_native as jln
from mono_slam_framework_tpu.params import SlamParameters as JParams
from mono_slam_framework_tpu.slam import frame as jframe
from mono_slam_framework_tpu.slam import fused_loftr as jfl
from mono_slam_framework_tpu.slam import map_model as jmm
from mono_slam_framework_tpu.slam import tracking as jtr
from mono_slam_framework_torch import sim
from mono_slam_framework_torch.matchers import loftr_matcher as plm
from mono_slam_framework_torch.models import loftr_native as pln
from mono_slam_framework_torch.params import SlamParameters
from mono_slam_framework_torch.slam import frame as pframe
from mono_slam_framework_torch.slam import fused_host, fused_loftr, fused_tracking
from mono_slam_framework_torch.slam import map_model as pmm
from mono_slam_framework_torch.slam import tracking as ptr

H, W, F = 480, 640, 500.0
K_MAT = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
THRESHOLD = 0.1
L = plm.L
N_POSES = 7  # keyframes 0-3 (local), keyframe 4 (outside), last frame 5, current 6

JAX = dict(Map=lambda: jmm.Map(use_native_graph=False), Frame=jframe.Frame,
           KeyFrame=jmm.KeyFrame, MapPoint=jmm.MapPoint, Tracking=jtr.Tracking,
           FrameFactory=jframe.FrameFactory, KeyFrameFactory=jmm.KeyFrameFactory,
           Params=JParams, reset=(jframe.reset_frame_ids, jmm.reset_map_ids),
           feats=jnp.asarray)
PORT = dict(Map=lambda: pmm.Map(use_native_graph=False), Frame=pframe.Frame,
            KeyFrame=pmm.KeyFrame, MapPoint=pmm.MapPoint,
            Tracking=lambda *a, **k: ptr.Tracking(*a, device="cpu", **k),
            FrameFactory=pframe.FrameFactory, KeyFrameFactory=pmm.KeyFrameFactory,
            Params=SlamParameters, reset=(pframe.reset_frame_ids, pmm.reset_map_ids),
            feats=lambda a: torch.from_numpy(np.array(a)))


class StubMatcher:
    """The matcher surface the LoFTR flow reads, over fixed features."""

    threshold = THRESHOLD
    fine = False
    cache_size = 512
    _sigma_octave = plm.LoftrFeatureMatcher._sigma_octave

    def __init__(self, P, feats):
        self.P, self.feats, self._feat_cache, self.seeded = P, feats, {}, []

    def _frame_key(self, frame):
        return frame.matcher_key

    def _features(self, frame):
        return self.P["feats"](self.feats[frame.matcher_key][None]), (1.0, 1.0)

    def seed_cache(self, frame, feats, scale):
        self.seeded.append(frame.matcher_key)


def _cell_of(uv):
    """The cell whose 16 px square holds pixel uv, or None outside the image."""
    x, y = int(uv[0] // plm.CELL), int(uv[1] // plm.CELL)
    return y * plm.GRID_W + x if 0 <= x < plm.GRID_W and 0 <= y < plm.GRID_H else None


@pytest.fixture(scope="module")
def scene():
    world = sim.PlaneWorld(width=W, height=H, f=F, second_plane=(3.0, 0.3))
    poses = sim.lateral_trajectory(N_POSES, step=0.05)
    model = pln.load_model(device="cpu")
    imgs = [world.render(T) for T in poses]
    feats = pln.encode(model, torch.from_numpy(np.stack(imgs)[:, None] / 255.0).float()).numpy()
    cells = np.arange(L)
    corner = np.stack([(cells % plm.GRID_W) * plm.CELL, (cells // plm.GRID_W) * plm.CELL], -1)
    # map points: every 3rd cell corner of keyframes 0 and 2 (local), and of
    # keyframe 4 (its points are extension rows of the last frame)
    points = []
    for k in (0, 2, 4):
        sel = corner[k::3].astype(np.float64)
        X, _ = chip_smoke.back_project(world, poses[k], sel)
        points += [(k, x) for x in X.astype(np.float32)]
    return {"poses": poses, "images": imgs, "feats": feats, "points": points, "world": world}


def _build(P, sc):
    """One package's map, keyframes 0-4, map points, last / current frames
    and tracker (velocity set, window = keyframes 0-3 in vote order)."""
    for r in P["reset"]:
        r()
    poses = sc["poses"]
    map_ = P["Map"]()
    frames = []
    for i in range(N_POSES):
        fr = P["Frame"](sc["images"][i], 0.1 * i, K_MAT, _id=i)
        fr.matcher_key = i
        if i < 6:
            fr.set_pose(poses[i])
        frames.append(fr)
    kfs = []
    for fr in frames[:5]:
        kf = P["KeyFrame"](fr, map_, None)
        kf.matcher_key = fr.matcher_key
        map_.add_keyframe(kf)
        kfs.append(kf)
    map_.keyframe_origins.append(kfs[0])
    last = frames[5]
    mps = []
    for home, X in sc["points"]:
        mp = P["MapPoint"](X, kfs[home], map_)
        seers = [kfs[home]] + ([kf for kf in kfs[:4] if kf is not kfs[home]] if home < 4 else [])
        for obs in seers + [last]:
            T = obs.Tcw
            Xc = T[:3, :3] @ X + T[:3, 3]
            c = _cell_of(K_MAT[:2, :2] @ (Xc[:2] / Xc[2]) + K_MAT[:2, 2])
            if c is None or obs is not kfs[home] and (c + 7 * mp.id) % 5 == 0:
                continue  # outside, or a seeded miss
            px = (int(c % plm.GRID_W * plm.CELL), int(c // plm.GRID_W * plm.CELL))
            if obs.keypoint_map.get_map_point(px) is not None:
                continue
            obs.keypoint_map.set_map_point(px, mp, measurement=(float(px[0]), float(px[1])),
                                           info=1.0 / 64)
            if obs is not last:
                mp.add_observation(obs, px, measurement=(float(px[0]), float(px[1])),
                                   info=1.0 / 64)
        mp.update_normal_and_depth()
        map_.add_map_point(mp)
        mps.append(mp)
    for kf in kfs:
        kf.update_connections()
    mps[3].set_bad_flag()
    m = StubMatcher(P, sc["feats"])
    params = P["Params"](fx=F, fy=F, cx=W / 2, cy=H / 2)
    tr = P["Tracking"](None, map_, None, params, m, P["FrameFactory"](),
                       P["KeyFrameFactory"](), verbose=False)
    tr.local_keyframes = [kfs[2], kfs[0], kfs[3], kfs[1]]
    tr.reference_kf = kfs[3]
    tr.last_frame = last.clone()
    tr.last_frame.matcher_key = 5
    tr.current_frame = frames[6]
    tr.velocity = (poses[5] @ np.linalg.inv(poses[4])).astype(np.float32)
    return tr, m, kfs, mps


@pytest.fixture(scope="module")
def twins(scene):
    return _build(JAX, scene), _build(PORT, scene)


def _ids(rows, ctx, ext, rcap):
    """Association rows (ctx rows, then extension rows from rcap) as
    map-point ids, -1 for none."""
    return [-1 if r < 0 else (ctx["mps"][r] if r < rcap else ext[r - rcap]).id
            for r in np.asarray(rows).astype(np.int64).tolist()]


def test_tables_match_jax(twins):
    (jt, jm, _, _), (pt, pm, _, _) = twins
    jtab = jfl._cell_tables(jt, jm)
    ptab = fused_loftr._cell_tables(pt)
    np.testing.assert_array_equal(ptab["pix"], jtab["pix"])
    np.testing.assert_array_equal(ptab["uv_host"], jtab["uv_host"])
    np.testing.assert_array_equal(ptab["uv"].numpy(), np.asarray(jtab["uv"]))
    assert ptab["cell_of_pix"] == jtab["cell_of_pix"] and ptab["scale"] == jtab["scale"]
    assert fused_loftr._cell_tables(pt) is ptab  # cached per resolution

    j = jfl._ensure_ctx(jt, jm, jtab)
    p = fused_loftr._ensure_ctx(pt, pm, ptab)
    nrows, n_kf = p["rcap"], p["n_kf"]
    assert p["key"] == j["key"] and n_kf == j["n_kf"] == 4
    assert [mp.id for mp in p["mps"]] == [mp.id for mp in j["mps"]]
    assert 300 < nrows <= j["rcap"] and 3 not in [mp.id for mp in p["mps"]]
    np.testing.assert_array_equal(p["kf_cellrow"].numpy(), np.asarray(j["kf_cellrow"])[:n_kf])
    assert (np.asarray(j["kf_cellrow"])[n_kf:] == -1).all()
    np.testing.assert_array_equal(p["pos"], j["pos"])
    np.testing.assert_array_equal(p["kf_feats"].numpy(), np.asarray(j["kf_feats"])[:n_kf])
    for k, pad in (("first_slot_d", -1), ("normal_d", 0), ("maxdist_d", 0), ("mp_pos_d", 0)):
        jk = np.asarray(j[k])
        np.testing.assert_array_equal(p[k].numpy(), jk[:nrows])
        assert (jk[nrows:] == pad).all()
    assert fused_loftr._ensure_ctx(pt, pm, ptab) is p  # unchanged map: reused
    assert fused_host.pipe_stats(pt)["ctx_builds"] == 1


def _jax_inputs(jt, jm):
    tab = jfl._cell_tables(jt, jm)
    ctx = jfl._ensure_ctx(jt, jm, tab)
    prev, ext = fused_loftr._prev_cellrow(jt, ctx, tab)  # rows past the JAX rcap
    T_init = (jt.velocity @ jt.last_frame.Tcw).astype(np.float32)
    f = jm._features
    args = (f(jt.current_frame)[0], None, f(jt.last_frame)[0], jnp.asarray(prev),
            jfl._mp_pos_for(ctx, ext), jnp.asarray(T_init), ctx["kf_feats"],
            ctx["kf_cellrow"], ctx["first_slot_d"], ctx["normal_d"], ctx["maxdist_d"],
            tab["uv"], jnp.asarray(K_MAT), jnp.float32(1.0 / 64))
    return tab, ctx, ext, args


def _port_inputs(pt, pm):
    tab = fused_loftr._cell_tables(pt)
    ctx = fused_loftr._ensure_ctx(pt, pm, tab)
    prev, ext = fused_loftr._prev_cellrow(pt, ctx, tab)
    T_init = (pt.velocity @ pt.last_frame.Tcw).astype(np.float32)
    f = pm._features
    args = (f(pt.current_frame)[0], None, f(pt.last_frame)[0], torch.from_numpy(prev),
            fused_host._mp_pos_for(pt, ctx, ext), torch.from_numpy(T_init), ctx["kf_feats"],
            ctx["kf_cellrow"], ctx["first_slot_d"], ctx["normal_d"], ctx["maxdist_d"],
            tab["uv"], torch.from_numpy(K_MAT), 1.0 / 64)
    return tab, ctx, ext, args


@pytest.fixture(scope="module")
def cores(twins):
    """Both packages' steady step on the same inputs: the JAX packed row and
    the port's outputs."""
    (jt, jm, _, _), (pt, pm, _, _) = twins
    jp = jln.load_params()
    model = pln.load_model(device="cpu")
    jtab, jctx, jext, jargs = _jax_inputs(jt, jm)
    # eager: compiling the whole core as one program takes longer on the CPU
    _, packed, _, _ = jfl._loftr_core(jargs[0], jp, *jargs[2:], THRESHOLD, float(W),
                                      float(H), use_pallas_lm=False)
    ptab, pctx, pext, pargs = _port_inputs(pt, pm)
    out, union_row, T2 = fused_loftr._loftr_core(pargs[0], model, *pargs[2:], THRESHOLD,
                                                 float(W), float(H))
    return (np.asarray(packed), jctx, jext), (out, union_row, pctx, pext)


def _unpack(p, rcap_j):
    """The JAX packed layout as named fields."""
    blk = p[18: 18 + 4 * L].reshape(4, L)
    off = 18 + 4 * L
    return {"T1": p[:16].reshape(4, 4), "n_good1": int(p[16]), "n_matches": int(p[17]),
            "row": blk[0].astype(np.int64), "okm": blk[1] > 0.5, "inlier1": blk[2] > 0.5,
            "j1": blk[3].astype(np.int64), "T2": p[off: off + 16].reshape(4, 4),
            "n_good2": int(p[off + 16]), "new_row": p[off + 17: off + 17 + L].astype(np.int64),
            "inlier2": p[off + 17 + L: off + 17 + 2 * L] > 0.5,
            "vis": p[off + 17 + 2 * L:] > 0.5}


def test_loftr_core_matches_jax(cores):
    (packed, jctx, jext), (out, union_row, pctx, pext) = cores
    j = _unpack(packed, jctx["rcap"])
    nrows = pctx["rcap"]
    assert j["n_matches"] > 50 and int(out.n_matches) == j["n_matches"]
    assert int(out.n_good1) == j["n_good1"] > 30 and int(out.n_good2) == j["n_good2"]
    for k in ("okm", "inlier1", "j1", "inlier2"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), j[k], err_msg=k)
    np.testing.assert_array_equal(out.vis.numpy(), j["vis"][:nrows])
    assert not j["vis"][nrows:].any()
    for k in ("row", "new_row"):
        assert (_ids(getattr(out, k).numpy(), pctx, pext, nrows)
                == _ids(j[k], jctx, jext, jctx["rcap"])), k
    assert sum(r >= nrows for r in out.row.tolist()) > 10  # extension rows in play
    assert (out.new_row >= 0).sum() > 10
    np.testing.assert_allclose(out.T1.numpy(), j["T1"], atol=1e-4)
    np.testing.assert_allclose(out.T2.numpy(), j["T2"], atol=1e-4)
    u = union_row.numpy()
    np.testing.assert_array_equal(u, np.where(out.new_row.numpy() >= 0, out.new_row.numpy(),
                                              np.where(out.row.numpy() >= 0, u, -1)))


def _state(tr, mps):
    cur = tr.current_frame
    assoc = {idx: (it.map_point.id, it.measurement, it.info, it.outlier)
             for idx, it in cur.keypoint_map.items()}
    points = {mp.id: (mp.n_visible, mp.n_found, mp.last_frame_seen,
                      mp.track_reference_for_frame) for mp in mps}
    chain = getattr(tr, "_loftr_chain", None)
    return {
        "assoc": assoc, "points": points, "inliers": tr.n_matches_inliers,
        "pose": None if cur.Tcw is None else np.round(cur.Tcw, 6).tolist(),
        "window": sorted(kf.id for kf in tr.local_keyframes),
        "reference": tr.reference_kf.id,
        "chain": None if chain is None else (chain["frame_id"], chain["T_prev_host"].tolist()),
        "match_image": tr.get_current_match_image().copy(),
    }


@pytest.mark.parametrize("case", ["full", "raw_matches", "motion"])
def test_replay_matches_jax(scene, cores, case):
    """Each package replays the JAX step's outputs (the port's in its own row
    space) into a fresh twin of the scene."""
    (packed, jctx0, jext0), _ = cores
    rcap_j = jctx0["rcap"]
    (jt, jm, _, jmps), (pt, pm, _, pmps) = _build(JAX, scene), _build(PORT, scene)
    jtab, jctx, jext, _ = _jax_inputs(jt, jm)
    ptab, pctx, pext, _ = _port_inputs(pt, pm)
    nrows = pctx["rcap"]
    assert [mp.id for mp in jext] == [mp.id for mp in pext]
    p = packed.copy()
    off2 = 18 + 4 * L + 17 + L  # inlier2
    p[18 + 2 * L: 18 + 3 * L: 9] = 0.0  # motion outliers: stamped, not associated
    p[off2: off2 + L: 7] = 0.0  # local outliers: associated, flagged
    if case == "raw_matches":
        p[17] = 10.0
    elif case == "motion":
        rows = p[18: 18 + L]  # keep 5 motion associations: below the gate of 10
        rows[np.nonzero(rows >= 0)[0][5:]] = -1.0
    j = _unpack(p, rcap_j)
    fields = {k: j[k] for k in fused_loftr.FIELDS}
    fields["vis"] = j["vis"][:nrows]
    for k in ("row", "new_row"):  # the port's row space: extension rows from nrows
        fields[k] = np.where(j[k] >= rcap_j, j[k] - rcap_j + nrows, j[k])
    fields["n_matches"] = np.int32(j["n_matches"])
    readback = fused_tracking.HostCopy({k: torch.from_numpy(np.asarray(v))
                                        for k, v in fields.items()})
    for tr in (jt, pt):
        tr.current_frame.keypoint_map.clear()
    got_j = jfl._replay_steady(jt, jm, jt.current_frame, jtab, jctx, jext, None,
                               lambda: p, ("chain",))
    got_p = fused_loftr._replay_steady(pt, pm, pt.current_frame, ptab, pctx, pext, None,
                                       readback, ("chain",))
    assert got_p == got_j
    assert (got_p is None) == (case != "full"), got_p
    sj, sp = _state(jt, jmps), _state(pt, pmps)
    np.testing.assert_array_equal(sp.pop("match_image"), sj.pop("match_image"))
    assert sp == sj
    assert pm.seeded == [6]
    if case == "full":
        assert sp["inliers"] > 50 and sp["chain"] is not None
        assert any(a[3] for a in sp["assoc"].values())  # outliers replayed
    else:
        expected = {"raw_matches": "fallback_raw_matches", "motion": "fallback_motion"}[case]
        assert fused_host.pipe_stats(pt)[expected] == 1
