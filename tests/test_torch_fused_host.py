"""Port parity for the fused tracking flow's host side (slam/fused_host.py).

  * the local-map context: on twin maps built from the same numpy with each
    package's classes, the port's `_ensure_ctx` (through
    convert.fused_ctx_to_numpy) equals the unpadded prefix of the JAX
    package's, exactly;
  * the host replay: one set of seeded steady outputs, packed into the JAX
    layout for the JAX `_replay_steady` and handed as named arrays to the
    port's, leaves both maps, frames and trackers in the same state, and
    both return None at the raw-match gate, the motion gate and the inlier
    floor;
  * the ctx cache: reused on an unchanged map, rebuilt after each change it
    keys on; KeyPointMap.version moves as in the JAX package;
  * end to end: the port's System on tests/test_fused.py's world, unfused,
    two-program, one-step and pipelined, within the bounds test_fused.py
    sets for the JAX package. With the ctx and replay parity above and the
    steady step's (test_torch_slice.py), this holds the fused flow to the
    JAX package's without running the JAX System.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch to one thread)
from mono_slam_framework_tpu.ops import orb as jorb
from mono_slam_framework_tpu.params import SlamParameters as JParams
from mono_slam_framework_tpu.slam import frame as jframe
from mono_slam_framework_tpu.slam import fused_host as jfh
from mono_slam_framework_tpu.slam import map_model as jmm
from mono_slam_framework_tpu.slam import tracking as jtr
from mono_slam_framework_torch import convert, sim
from mono_slam_framework_torch.io import trajectory
from mono_slam_framework_torch.matchers import OrbFeatureMatcher
from mono_slam_framework_torch.params import SlamParameters
from mono_slam_framework_torch.slam import KeyFrameMatchDatabase, System
from mono_slam_framework_torch.slam import frame as pframe
from mono_slam_framework_torch.slam import fused_host, fused_tracking
from mono_slam_framework_torch.slam import map_model as pmm
from mono_slam_framework_torch.slam import tracking as ptr
from mono_slam_framework_torch.slam.frame import reset_frame_ids
from mono_slam_framework_torch.slam.map_model import reset_map_ids

H, W, F = 240, 320, 250.0
K_MAT = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
N_SLOTS = 256  # feature slots of the seeded steady outputs
MAX_FEATURES = 2000  # the stub matcher's: the inlier floor is 0.06 * 2000 = 120

JAX = dict(Map=lambda: jmm.Map(use_native_graph=False), Frame=jframe.Frame,
           KeyFrame=jmm.KeyFrame, MapPoint=jmm.MapPoint, Tracking=jtr.Tracking,
           FrameFactory=jframe.FrameFactory, KeyFrameFactory=jmm.KeyFrameFactory,
           Params=JParams, reset=(jframe.reset_frame_ids, jmm.reset_map_ids),
           feats=lambda d: jorb.Features(**{k: jnp.asarray(v) for k, v in d.items()}))
PORT = dict(Map=lambda: pmm.Map(use_native_graph=False), Frame=pframe.Frame,
            KeyFrame=pmm.KeyFrame, MapPoint=pmm.MapPoint,
            Tracking=lambda *a, **k: ptr.Tracking(*a, device="cpu", **k),
            FrameFactory=pframe.FrameFactory, KeyFrameFactory=pmm.KeyFrameFactory,
            Params=SlamParameters, reset=(reset_frame_ids, reset_map_ids),
            feats=lambda d: convert.features_from_numpy(d, "cpu"))


def _pose(x):
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -x
    return T


def _features(rng, n=N_SLOTS):
    return {
        "xy": rng.uniform([0, 0], [W - 1, H - 1], (n, 2)).astype(np.float32),
        "angle": rng.uniform(-3, 3, n).astype(np.float32),
        "desc": rng.integers(0, 2**32, (n, 8), dtype=np.uint32),
        "score": rng.uniform(0, 1, n).astype(np.float32),
        "valid": np.ones(n, bool),
        "octave": rng.integers(0, 8, n).astype(np.int32),
    }


class StubMatcher:
    """features_for / seed_cache over fixed feature sets, keyed by object."""

    threshold = 0.7
    fast_threshold = 20.0
    max_features = MAX_FEATURES

    def __init__(self, wrap):
        self.wrap, self.by_obj = wrap, {}

    def features_for(self, frame):
        return self.by_obj[id(frame)]

    def seed_cache(self, frame, feats):
        pass


def _scene(seed=0):
    """The numpy scene: 5 keyframes (4 in the local window), 80 map points
    with their observations (pixel, subpixel measurement, octave weight)."""
    rng = np.random.default_rng(seed)
    kf_x = [0.0, 0.1, 0.2, 0.3, 0.4]
    n_mp = 80
    pos = np.stack([rng.uniform(-2, 2, n_mp), rng.uniform(-1.5, 1.5, n_mp),
                    rng.uniform(4, 8, n_mp)], -1).astype(np.float32)
    obs = []  # per map point: [(kf index, (x, y), measurement, info)]
    for j in range(n_mp):
        # the last 10 points are seen only by keyframe 4, outside the window
        kfs = [4] if j >= 70 else sorted(rng.choice(4, rng.integers(2, 5), replace=False))
        o = []
        for k in kfs:
            Xc = pos[j] - np.array([kf_x[k], 0, 0], np.float32)
            uv = K_MAT[:2, :2] @ (Xc[:2] / Xc[2]) + K_MAT[:2, 2]
            o.append((k, (int(uv[0]), int(uv[1])), (float(uv[0]), float(uv[1])),
                      float(1.2 ** (-2.0 * (j % 3)))))
        obs.append(o)
    return {"kf_x": kf_x, "pos": pos, "obs": obs,
            "kf_feats": [_features(rng) for _ in kf_x]}


def _build(P, sc):
    """One package's map, keyframes, map points and tracker for the scene.
    Point 5 is culled (set_bad_flag) before any context is built."""
    for r in P["reset"]:
        r()
    map_ = P["Map"]()
    kfs = []
    for x in sc["kf_x"]:
        fr = P["Frame"](np.zeros((H, W), np.float32), 0.0, K_MAT)
        fr.set_pose(_pose(x))
        kf = P["KeyFrame"](fr, map_, None)
        map_.add_keyframe(kf)
        kfs.append(kf)
    map_.keyframe_origins.append(kfs[0])
    mps = []
    for j, o in enumerate(sc["obs"]):
        mp = P["MapPoint"](sc["pos"][j], kfs[o[0][0]], map_)
        for k, px, meas, info in o:
            kfs[k].keypoint_map.set_map_point(px, mp, measurement=meas, info=info)
            mp.add_observation(kfs[k], px, measurement=meas, info=info)
        mp.update_normal_and_depth()
        map_.add_map_point(mp)
        mps.append(mp)
    for kf in kfs:
        kf.update_connections()
    mps[5].set_bad_flag()
    m = StubMatcher(P["feats"])
    for kf, f in zip(kfs, sc["kf_feats"]):
        m.by_obj[id(kf)] = P["feats"](f)
    params = P["Params"](fx=F, fy=F, cx=W / 2, cy=H / 2, max_features=MAX_FEATURES)
    tr = P["Tracking"](None, map_, None, params, m, P["FrameFactory"](),
                       P["KeyFrameFactory"](), verbose=False)
    tr.local_keyframes = [kfs[2], kfs[0], kfs[3], kfs[1]]  # vote order, not id order
    tr.reference_kf = kfs[3]
    return tr, m, kfs, mps


def test_ctx_matches_jax_prefix():
    sc = _scene()
    jt, jm, _, _ = _build(JAX, sc)
    pt, pm, _, _ = _build(PORT, sc)
    j = jfh._ensure_ctx(jt, jm)
    p = convert.fused_ctx_to_numpy(fused_host._ensure_ctx(pt, pm))
    nrows, n_kf = p["rcap"], p["n_kf"]
    assert p["key"] == j["key"] and n_kf == j["n_kf"] == 4
    assert p["mps"] == [mp.id for mp in j["mps"]]  # row order, by map-point id
    assert 60 < nrows <= j["rcap"] and 5 not in p["mps"]
    assert p["row_of"] == {mp.id: j["row_of"][id(mp)] for mp in j["mps"]}
    for k in ("first_slot", "pos", "normal", "maxdist"):
        np.testing.assert_array_equal(p[k], j[k])
    # the keyframe tables: each keyframe's (px, row) list, then -1 padding
    m2 = p["kf_px"].shape[1]
    for k in ("kf_px", "kf_row"):
        jk = np.asarray(j[k])
        np.testing.assert_array_equal(p[k], jk[:n_kf, :m2])
        assert (jk[:n_kf, m2:] == -1).all()
    assert (np.asarray(j["kf_row"])[n_kf:] == -1).all()
    assert ((p["kf_row"] >= 0).sum(1) > 0).all() and (p["kf_row"][:, -1] >= 0).any()
    for k, pad in (("first_slot_d", -1), ("normal_d", 0), ("maxdist_d", 0), ("mp_pos_d", 0)):
        jk = np.asarray(j[k])
        np.testing.assert_array_equal(p[k], jk[:nrows])
        assert (jk[nrows:] == pad).all()
    np.testing.assert_array_equal(p["first_slot_d"], p["first_slot"])
    np.testing.assert_array_equal(p["mp_pos_d"], p["pos"])


def _outputs(nrows, n_ext, case):
    """Seeded steady outputs over abstract rows: ctx rows 0..nrows-1, then
    extension rows nrows + j. Distinct pixels per slot (the device resolves
    duplicates before the host sees them)."""
    rng = np.random.default_rng(7)
    k = N_SLOTS
    flat = rng.choice(H * W, k, replace=False)
    xy = np.stack([flat % W, flat // W], -1).astype(np.float32) + rng.uniform(0, 0.9, (k, 2)).astype(np.float32)
    # 60 motion associations to distinct rows, 4 of them extension rows
    row = np.full(k, -1)
    assoc = rng.choice(k, 60, replace=False)
    row[assoc] = rng.permutation(nrows)[:60]
    row[assoc[:4]] = nrows + np.arange(4) % n_ext
    keep = (row >= 0) & (rng.random(k) < 0.9)
    inlier = keep & (rng.random(k) < 0.85)
    new_row = np.where(~(keep & inlier) & (rng.random(k) < 0.5), rng.integers(0, nrows, k), -1)
    inlier2 = rng.random(k) < 0.9
    out = {
        "T1": _pose(0.31) + rng.normal(0, 1e-3, (4, 4)).astype(np.float32),
        "n_matches": np.int32(150), "row": row.astype(np.int32), "keep": keep,
        "inlier": inlier, "idx2": rng.integers(0, k, k), "ok": rng.random(k) < 0.7,
        "xy": xy, "octave": rng.integers(0, 8, k).astype(np.int32),
        "T2": _pose(0.32), "new_row": new_row.astype(np.int32),
        "inlier2": inlier2, "vis": rng.random(nrows) < 0.5,
    }
    if case == "raw_matches":
        out["n_matches"] = np.int32(10)
    elif case == "motion":
        out["keep"] = keep & (np.cumsum(keep) <= 5)
    elif case == "inlier_floor":
        out["inlier2"] = inlier2 & (np.cumsum(inlier2) <= 100)
    return out


def _jax_packed(o, nrows, rcap):
    """The outputs in the JAX package's packed f32 steady layout, its row
    space (extension rows from rcap on) and its rcap-long vis."""
    def rows(r):
        return np.where(r >= nrows, r - nrows + rcap, r)

    f = lambda a: np.asarray(a, np.float32).ravel()  # noqa: E731
    vis = np.zeros(rcap, np.float32)
    vis[:nrows] = o["vis"]
    return np.concatenate([
        f(o["T1"]), f([0]), f([o["n_matches"]]), f(rows(o["row"])), f(o["keep"]),
        f(o["inlier"]), f(o["idx2"]), f(o["ok"]), f(o["xy"][:, 0]), f(o["xy"][:, 1]),
        f(o["octave"]), f(o["T2"]), f([0]), f(o["new_row"]), f(o["inlier2"]), vis,
    ])


def _replay_setup(P, sc):
    """Tracker with its ctx built, a last frame (associated to ctx and
    extension points) and a current frame; points 7 and 71 turn bad after
    the ctx was built."""
    tr, m, kfs, mps = _build(P, sc)
    ctx = (jfh if P is JAX else fused_host)._ensure_ctx(tr, m)
    last = P["Frame"](np.zeros((H, W), np.float32), 0.9, K_MAT, _id=9)
    last.set_pose(_pose(0.3))
    last.reference_kf = kfs[3]
    for j in range(0, 80, 3):
        last.keypoint_map.set_map_point((j, j), mps[j])
    cur = P["Frame"](np.zeros((H, W), np.float32), 1.0, K_MAT, _id=10)
    tr.last_frame, tr.current_frame = last.clone(), cur
    m.by_obj[id(tr.last_frame)] = P["feats"](_features(np.random.default_rng(3)))
    ext = mps[70:73]  # outside the window: extension rows
    mps[7].set_bad_flag()
    mps[71].set_bad_flag()
    return tr, m, ctx, ext, mps


def _state(tr, mps):
    cur = tr.current_frame
    assoc = {idx: (it.map_point.id, it.measurement, it.info, it.outlier)
             for idx, it in cur.keypoint_map.items()}
    points = {mp.id: (mp.n_visible, mp.n_found, mp.last_frame_seen,
                      mp.track_reference_for_frame, mp.is_bad) for mp in mps}
    saved = getattr(tr, "_fused_prev_assoc", None)
    if saved is not None:
        saved = (saved["frame_id"], saved["version"], saved["px"].tolist(),
                 saved["row"].tolist(), [mp.id for mp in saved["ext"]])
    chain = getattr(tr, "_fused_chain", None)
    return {
        "assoc": assoc, "points": points, "saved": saved,
        "inliers": tr.n_matches_inliers,
        "pose": None if cur.Tcw is None else cur.Tcw.tolist(),
        "window": sorted(kf.id for kf in tr.local_keyframes),
        "reference": tr.reference_kf.id,
        "chain": None if chain is None else (chain["frame_id"], chain["T_prev_host"].tolist()),
        "stats": {k: v for k, v in jfh.pipe_stats(tr).items() if k == "miss_quality"},
        "match_image": tr.get_current_match_image().copy(),
    }


@pytest.mark.parametrize("case", ["full", "raw_matches", "motion", "inlier_floor"])
def test_replay_matches_jax(case):
    sc = _scene()
    jt, jm, jctx, jext, jmps = _replay_setup(JAX, sc)
    pt, pm, pctx, pext, pmps = _replay_setup(PORT, sc)
    nrows = pctx["rcap"]
    assert nrows == len(jctx["mps"])
    out = _outputs(nrows, len(pext), case)
    cols = jt.current_frame.keypoint_map.cols
    got_j = jfh._replay_steady(
        jt, jm, jt.current_frame, cols, jctx, jctx["rcap"], nrows, jext,
        jm.features_for(jt.last_frame), None, _jax_packed(out, nrows, jctx["rcap"]),
        ("chain",),
    )
    readback = fused_tracking.HostCopy({k: torch.from_numpy(np.asarray(v)) for k, v in out.items()})
    got_p = fused_host._replay_steady(
        pt, pm, pt.current_frame, cols, pctx, pext, pm.features_for(pt.last_frame), None,
        readback, ("chain",),
    )
    assert got_p == got_j
    assert (got_p is None) == (case != "full"), got_p
    sj, sp = _state(jt, jmps), _state(pt, pmps)
    np.testing.assert_array_equal(sp.pop("match_image"), sj.pop("match_image"))
    assert sp == sj
    if case == "full":
        assert sp["inliers"] > 50 and sp["saved"] is not None
        assert min(sp["saved"][3]) < 0  # extension rows are carried, encoded
        assert sum(a[3] for a in sp["assoc"].values()) > 0  # outliers replayed
    expected = {"raw_matches": "fallback_raw_matches", "motion": "fallback_motion",
                "inlier_floor": "miss_quality"}.get(case)
    if expected:
        assert fused_host.pipe_stats(pt)[expected] == 1


def test_ctx_cache_invalidation():
    tr, m, kfs, mps = _build(PORT, _scene())
    ctx = fused_host._ensure_ctx(tr, m)
    assert fused_host._ensure_ctx(tr, m) is ctx  # unchanged map: reused
    tr.local_keyframes = list(reversed(tr.local_keyframes))
    assert fused_host._ensure_ctx(tr, m) is ctx  # same set, other order
    changes = [
        lambda: mps[0].set_world_pos(mps[0].world_pos + 0.01),
        lambda: mps[1].update_normal_and_depth(),
        lambda: kfs[2].keypoint_map.set_map_point((3, 4), mps[2]),
        lambda: setattr(mps[3], "is_bad", True),
        lambda: tr.local_keyframes.append(kfs[4]),
    ]
    for change in changes:
        change()
        new = fused_host._ensure_ctx(tr, m)
        assert new is not ctx
        assert fused_host._ensure_ctx(tr, m) is new
        ctx = new
    assert fused_host.pipe_stats(tr)["ctx_builds"] == 1 + len(changes)
    assert 3 not in [mp.id for mp in ctx["mps"]]


def test_keypoint_map_version_as_in_jax():
    def ops(P):
        kp = (jframe if P is JAX else pframe).KeyPointMap(W, H)
        versions = []
        for op in (
            lambda: kp.set_map_point((1, 2), "a"),
            lambda: kp.set_map_point((W + 5, 2), "b"),  # out of bounds: no change
            lambda: kp.set_map_point_by_index(2 * W + 1, None),
            lambda: kp.bulk_set_map_points([5, 6, 7], "xyz", [(5.0, 0.0)] * 3, [1.0] * 3),
            lambda: kp.clear(),
            lambda: kp.set_map_point((3, 3), "c"),
        ):
            op()
            versions.append(kp.version)
        clone = kp.clone()
        return versions, clone.version, sorted(clone.items()) == sorted(kp.items())

    got = ops(PORT)
    assert got == ops(JAX)
    assert got[1] == 0 and got[2]


# ---------------------------------------------------------------------------
# end to end: tests/test_fused.py's world through the port's System


def _run(world, poses, pipelined=False, **flags):
    reset_frame_ids()
    reset_map_ids()
    params = SlamParameters(fx=world.f, fy=world.f, cx=world.cx, cy=world.cy,
                            max_features=400, minIniMatchCount=100,
                            initializerModelFallback=True, **flags)
    matcher = OrbFeatureMatcher(threshold=0.7, max_features=400, device="cpu")
    system = System(params, matcher, KeyFrameMatchDatabase(matcher), verbose=False,
                    device="cpu")
    system.toggle_initialization_allowed()
    states, outs = [], []
    for i, T in enumerate(poses):
        img = world.render(T)
        if pipelined:
            outs.append(system.track_monocular_pipelined(img, i * 0.1))
        else:
            system.track_monocular(img, i * 0.1)
            states.append(system.tracker.state.name)
    final = system.flush_pipeline() if pipelined else None
    return system, states, outs, final


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    world = sim.PlaneWorld(second_plane=(3.0, 0.3))
    poses = sim.lateral_trajectory(20, step=0.07)
    out = {
        "unfused": _run(world, poses, fusedTracking=False),
        "two_program": _run(world, poses, fusedOneStep=False),
        "one_step": _run(world, poses),  # the SlamParameters defaults
        "pipelined": _run(world, poses, pipelined=True),
    }
    gt_t = np.arange(len(poses)) * 0.1
    gt_p = np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in poses])
    tum = {}
    for name, (system, *_) in out.items():
        path = str(tmp_path_factory.mktemp("tum") / f"{name}.txt")
        system.save_trajectory_tum(path)
        tum[name] = trajectory.read_tum(path)[:2]
    return out, tum, (gt_t, gt_p)


@pytest.mark.parametrize("mode,map_share", [("two_program", 0.2), ("one_step", 0.25)])
def test_fused_system_matches_unfused(runs, mode, map_share):
    out, tum, gt = runs
    ref, st_ref, *_ = out["unfused"]
    system, states, *_ = out[mode]
    assert states == st_ref and states[-1] == "OK"
    assert sum(s == "OK" for s in states) >= 10
    assert abs(system.map.n_keyframes() - ref.map.n_keyframes()) <= 1
    ref_mp = ref.map.n_map_points()
    assert abs(system.map.n_map_points() - ref_mp) <= map_share * ref_mp
    stats = fused_host.pipe_stats(system.tracker)
    done = "done_steady" if mode == "one_step" else "done_two_program"
    assert stats.get(done, 0) >= 10, stats
    ate, _ = trajectory.ate_rmse(*tum[mode], *gt)
    ate_ref, _ = trajectory.ate_rmse(*tum["unfused"], *gt)
    assert ate < 0.15 and ate_ref < 0.15, (ate, ate_ref)
    pair, n = trajectory.ate_rmse(*tum[mode], *tum["unfused"])
    assert n >= 10
    assert pair < (0.05 if mode == "one_step" else 0.03), pair


def test_pipelined_matches_one_step(runs):
    out, tum, gt = runs
    system, _, outs, final = out["pipelined"]
    assert outs[0] is None  # the first call has nothing completed yet
    assert final is not None and final["state"] == "OK"
    stats = fused_host.pipe_stats(system.tracker)
    assert stats["hit"] >= 5, stats
    misses = sum(v for k, v in stats.items() if k.startswith("miss_"))
    assert stats["hit"] + misses <= stats["dispatch"]
    assert len(stats["process_samples_ms"]) == len(stats["dispatch_samples_ms"]) == 20
    pair, n = trajectory.ate_rmse(*tum["pipelined"], *tum["one_step"])
    assert n >= 10
    assert pair < 0.03, pair
    ate, _ = trajectory.ate_rmse(*tum["pipelined"], *gt)
    assert ate < 0.15, ate
