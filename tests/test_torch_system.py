"""Port parity for the slice as a whole: System.track_monocular, the
reference-twin flow (fusedTracking=False), against the JAX package's System
on tests/test_pipeline.py's sequence (320x240, 400 features, step 0.07).

The JAX System runs once, only as far as it must (initialization on frame 3
and 3 tracked frames): a full-length JAX run costs minutes on the CPU.

  * Short run on both Systems, each extracting its own features: both
    initialize on the same frame, the initial map-point counts agree within
    5 %, and the tracked frames' camera centres within 1e-2 (the scale is
    fixed by both initializers' median-depth rule).
  * Stage parity on one map: the JAX map right after initialization,
    carried to the port with convert.snapshot_map / map_from_snapshot, and
    the JAX features of every image given to both matchers. On it,
    optimize_frame_pose, track_reference_keyframe + track_local_map and one
    local BA (run_local_ba over a third keyframe) agree: poses within 1e-3,
    inlier counts within 2, map points within 1e-3 relative, and the same
    observations erased.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_world import PlaneWorld, lateral_trajectory
from torch_parity import jax_features_np  # (also pins torch to one thread)
from mono_slam_framework_tpu.matchers import OrbFeatureMatcher as JMatcher
from mono_slam_framework_tpu.ops import orb as jorb
from mono_slam_framework_tpu.params import SlamParameters as JParams
from mono_slam_framework_tpu.slam import System as JSystem
from mono_slam_framework_tpu.slam import device_io as jdio
from mono_slam_framework_tpu.slam import frame as jframe
from mono_slam_framework_tpu.slam import kfdb as jkfdb
from mono_slam_framework_tpu.slam import local_mapping as jlm
from mono_slam_framework_tpu.slam import map_model as jmm
from mono_slam_framework_tpu.slam import tracking as jtr
from mono_slam_framework_torch import convert
from mono_slam_framework_torch.geometry import se3
from mono_slam_framework_torch.matchers import OrbFeatureMatcher
from mono_slam_framework_torch.params import SlamParameters
from mono_slam_framework_torch.slam import System, device_io, frame, kfdb, local_mapping
from mono_slam_framework_torch.slam import map_model, tracking

N_SHORT = 7  # initialization on frame 3, then 3 tracked frames
CPU = "cpu"


def _params(P, world, **kw):
    return P(fx=world.f, fy=world.f, cx=world.cx, cy=world.cy, max_features=400,
             minIniMatchCount=100, initializerModelFallback=True, fusedTracking=False, **kw)


@pytest.fixture(scope="module")
def scene():
    world = PlaneWorld(second_plane=(3.0, 0.3))
    poses = lateral_trajectory(28, step=0.07)
    return world, poses, [world.render(T) for T in poses[:N_SHORT]]


def _short_run(system, images, reset, features_of=None):
    reset()
    system.toggle_initialization_allowed()
    out = {"states": [], "centres": [], "n_mp": [], "feats": [], "snapshot": None}
    for i, img in enumerate(images):
        system.track_monocular(img, timestamp=i * 0.1)
        out["states"].append(system.tracker.state.name)
        out["n_mp"].append(system.map.n_map_points())
        out["centres"].append(system.tracker.current_frame.get_camera_center())
        if features_of is not None:
            out["feats"].append(features_of(system.tracker.current_frame))
        if out["snapshot"] is None and out["states"][-1] == "OK":
            out["snapshot"] = convert.snapshot_map(system.map)
    return out


@pytest.fixture(scope="module")
def jax_run(scene):
    world, _, images = scene
    m = JMatcher(threshold=0.7, max_features=400)
    system = JSystem(_params(JParams, world, prewarmShapes=False), m,
                     jkfdb.KeyFrameMatchDatabase(m), verbose=False)

    def reset():
        jframe.reset_frame_ids()
        jmm.reset_map_ids()

    return _short_run(system, images, reset,
                      lambda f: jax_features_np(m.features_for(f)))


@pytest.fixture(scope="module")
def port_run(scene):
    world, _, images = scene
    m = OrbFeatureMatcher(threshold=0.7, max_features=400, device=CPU)
    system = System(_params(SlamParameters, world), m, kfdb.KeyFrameMatchDatabase(m),
                    verbose=False, device=CPU)

    def reset():
        frame.reset_frame_ids()
        map_model.reset_map_ids()

    return _short_run(system, images, reset)


def test_short_run_matches_jax_system(jax_run, port_run):
    assert jax_run["states"] == port_run["states"]
    first = jax_run["states"].index("OK")
    assert first == 3 and jax_run["states"][first:] == ["OK"] * (N_SHORT - first)
    n_j, n_p = jax_run["n_mp"][first], port_run["n_mp"][first]
    assert abs(n_p - n_j) <= 0.05 * n_j, (n_p, n_j)
    for c_j, c_p in zip(jax_run["centres"][first:], port_run["centres"][first:]):
        np.testing.assert_allclose(c_p, c_j, atol=1e-2)


# ---------------------------------------------------------------------------
# stage parity on one map


def _side(pkg, snap, feats, images, world):
    """One package's map (from the snapshot), matcher (seeded with the JAX
    features), tracker and local mapper, plus frame 4 as a new Frame."""
    if pkg == "jax":
        classes = (lambda: jmm.Map(use_native_graph=False), jframe.Frame,
                   jmm.KeyFrame, jmm.MapPoint)
        Matcher, Frame, KFF, FF = JMatcher, jframe.Frame, jmm.KeyFrameFactory, jframe.FrameFactory
        params = _params(JParams, world, prewarmShapes=False)
        db = jkfdb.KeyFrameMatchDatabase
        dev = {}
    else:
        classes = (lambda: map_model.Map(use_native_graph=False), frame.Frame,
                   map_model.KeyFrame, map_model.MapPoint)
        Matcher, Frame, KFF, FF = (OrbFeatureMatcher, frame.Frame, map_model.KeyFrameFactory,
                                   frame.FrameFactory)
        params = _params(SlamParameters, world)
        db = kfdb.KeyFrameMatchDatabase
        dev = {"device": CPU}
    m = Matcher(threshold=0.7, max_features=400, **dev)
    kf_db = db(m)
    map_, kfs, _ = convert.map_from_snapshot(snap, kf_db, classes)

    def seed(f, i):
        if pkg == "jax":
            m.seed_cache(f, jorb.Features(**{k: jnp.asarray(v) for k, v in feats[i].items()}))
        else:
            m.seed_cache(f, convert.features_from_numpy(feats[i], device=CPU))

    for kf in kfs.values():
        seed(kf, kf.frame_id)
    cur = Frame(images[4], 0.4, world.K, _id=4)
    seed(cur, 4)
    tr = (jtr if pkg == "jax" else tracking).Tracking(
        None, map_, kf_db, params, m, FF(), KFF(), verbose=False, **dev)
    lm = (jlm if pkg == "jax" else local_mapping).LocalMapping(
        map_, m, params, *dev.values(), verbose=False)
    tr.local_mapper = lm
    return {"map": map_, "kfs": kfs, "tracker": tr, "mapper": lm, "cur": cur, "Frame": Frame,
            "kff": KFF(), "kf_db": kf_db,
            "optimize": (jdio.optimize_frame_pose if pkg == "jax"
                         else lambda f: device_io.optimize_frame_pose(f, CPU)),
            "local_ba": (jdio.run_local_ba if pkg == "jax"
                         else lambda kf, mp: device_io.run_local_ba(kf, mp, CPU))}


@pytest.fixture(scope="module")
def stages(scene, jax_run):
    world, _, images = scene
    snap, feats = jax_run["snapshot"], jax_run["feats"]
    assert snap is not None and len(snap["keyframes"]) == 2
    return {pkg: _side(pkg, snap, feats, images, world) for pkg in ("jax", "port")}


def test_optimize_frame_pose_on_one_map(stages):
    """Frame 4 with keyframe 1's associations, started off its pose."""
    res = {}
    for pkg, s in stages.items():
        kf = s["kfs"][1]
        f = s["Frame"](kf.image, 0.4, kf.K, _id=40)
        for idx, item in kf.keypoint_map.items():
            f.keypoint_map.set_map_point(kf.keypoint_map.keypoint_from_index(idx),
                                         item.map_point, measurement=item.measurement,
                                         info=item.info)
        dT = se3.exp_se3(torch.tensor([0.01, -0.005, 0.003, 0.02, 0.01, -0.01])).numpy()
        f.set_pose(dT @ kf.Tcw)
        n_good = s["optimize"](f)
        res[pkg] = (f.Tcw, n_good, sorted(i for i, it in f.keypoint_map.items() if it.outlier))
    np.testing.assert_allclose(res["port"][0], res["jax"][0], atol=1e-3)
    assert abs(res["port"][1] - res["jax"][1]) <= 2
    assert res["jax"][1] > 100


@pytest.fixture(scope="module")
def tracked(stages):
    """track_reference_keyframe then track_local_map on frame 4, then a
    keyframe from it through process_new_keyframe and one run_local_ba."""
    out = {}
    for pkg, s in stages.items():
        tr, kf_cur = s["tracker"], s["kfs"][1]
        tr.current_frame = s["cur"]
        tr.reference_kf = kf_cur
        tr.last_frame = s["Frame"](kf_cur.image, 0.3, kf_cur.K, _id=3)
        tr.last_frame.set_pose(kf_cur.Tcw)
        ok_ref = tr.track_reference_keyframe()
        T_ref = tr.current_frame.Tcw.copy()
        ok_local = tr.track_local_map()
        rec = {"ok": (ok_ref, ok_local), "T_ref": T_ref, "T": tr.current_frame.Tcw.copy(),
               "inliers": tr.n_matches_inliers}
        kf = s["kff"].create(tr.current_frame, s["map"], s["kf_db"])
        s["mapper"].insert_keyframe(kf)
        s["mapper"].process_new_keyframe()
        obs_before = {mp.id: {k.id for k in mp.observations} for mp in s["map"].all_map_points()}
        s["local_ba"](kf, s["map"])
        rec["kf_T"] = kf.Tcw.copy()
        rec["points"] = {mp.id: mp.world_pos.copy() for mp in s["map"].all_map_points()}
        rec["obs"] = {mp.id: sorted(k.id for k in mp.observations)
                      for mp in s["map"].all_map_points()}
        rec["n_erased"] = sum(len(v) for v in obs_before.values()) - sum(
            len(v) for v in rec["obs"].values())
        out[pkg] = rec
    return out


def test_track_local_map_on_one_map(tracked):
    j, p = tracked["jax"], tracked["port"]
    assert j["ok"] == p["ok"] == (True, True)
    np.testing.assert_allclose(p["T_ref"], j["T_ref"], atol=1e-3)
    np.testing.assert_allclose(p["T"], j["T"], atol=1e-3)
    assert abs(p["inliers"] - j["inliers"]) <= 2
    assert j["inliers"] > 100


def test_local_ba_on_one_map(tracked):
    j, p = tracked["jax"], tracked["port"]
    np.testing.assert_allclose(p["kf_T"], j["kf_T"], atol=1e-3)
    # the same observations erased, so the same map points keep the same ones
    assert p["n_erased"] == j["n_erased"]
    assert p["obs"] == j["obs"]
    ids = sorted(j["points"])
    assert sorted(p["points"]) == ids and len(ids) > 100
    np.testing.assert_allclose(np.stack([p["points"][i] for i in ids]),
                               np.stack([j["points"][i] for i in ids]), rtol=1e-3, atol=1e-3)
