"""The port's map viewer (viz/map_drawer.py) and checkpoints (io/checkpoint.py).

  * tests/test_viz.py's two tests against the port's MapDrawer (the live
    viewer's PNG and HTTP endpoint on a port of its own);
  * MapDrawer.update() on twin maps (one convert.snapshot_map rebuilt with
    each package's classes) gives the JAX drawer's points, keyframe centres
    and view directions, exactly;
  * a checkpoint written by either package loads in the other, and one
    written by the port loads in the port: the loaded maps hold the same
    keyframes (ids, poses, parents, association tables with measurements,
    weights and outlier flags) and map points (positions, normals,
    counters, observations) as the JAX package's own round trip.
"""

import time
import urllib.request

import numpy as np
import pytest

import torch_parity  # noqa: F401  (pins torch to one thread)
from mono_slam_framework_tpu.io import checkpoint as jckpt
from mono_slam_framework_tpu.slam import frame as jframe
from mono_slam_framework_tpu.slam import map_model as jmm
from mono_slam_framework_tpu.viz.map_drawer import MapDrawer as JDrawer
from mono_slam_framework_torch import convert, sim
from mono_slam_framework_torch.io import checkpoint as pckpt
from mono_slam_framework_torch.slam import frame as pframe
from mono_slam_framework_torch.slam import map_model as pmm
from mono_slam_framework_torch.viz.map_drawer import MapDrawer

H, W, F = 120, 160, 125.0
K_MAT = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
JAX_CLASSES = (lambda: jmm.Map(use_native_graph=False), jframe.Frame, jmm.KeyFrame,
               jmm.MapPoint)
PORT_CLASSES = (lambda: pmm.Map(use_native_graph=False), pframe.Frame, pmm.KeyFrame,
                pmm.MapPoint)


# ---------------------------------------------------------------------------
# tests/test_viz.py on the port


class _MP:
    def __init__(self, pos):
        self.world_pos = np.asarray(pos, np.float32)
        self.is_bad = False


class _KF:
    def __init__(self, center, Tcw=None):
        self._c = np.asarray(center, np.float32)
        self.is_bad = False
        self.Ow = self._c
        if Tcw is not None:
            self.Tcw = np.asarray(Tcw, np.float32)

    def get_camera_center(self):
        return self._c


class _Map:
    def __init__(self):
        self.mps = [_MP([0, 0, 5]), _MP([1, 0, 6]), _MP([0, 1, 4])]
        self.kfs = [_KF([0, 0, 0], Tcw=np.eye(4)), _KF([0.5, 0, 0])]

    def all_map_points(self):
        return self.mps

    def all_keyframes(self):
        return self.kfs


def test_snapshot_and_save(tmp_path):
    d = MapDrawer(_Map())
    d.start()
    d.update()
    d.set_pos_dir(0, 0, 0, 0, 0, 1)
    assert d.points.shape == (3, 3)
    assert d.kf_centers.shape == (2, 3)
    assert d.kf_dirs.shape == (2, 3)
    np.testing.assert_allclose(d.kf_dirs[0], [0, 0, 1])
    out = tmp_path / "map.npz"
    d.save(str(out))
    z = np.load(out)
    assert z["points"].shape == (3, 3)
    assert z["kf_dirs"].shape == (2, 3)
    assert z["trajectory"].shape == (1, 3)
    png = tmp_path / "frusta.png"
    d.render(str(png))
    assert png.exists() and png.stat().st_size > 0
    d.stop()


def test_live_viewer_thread_and_http(tmp_path):
    d = MapDrawer(_Map())
    d.start()
    png = tmp_path / "live.png"
    port = 18473  # test_viz.py serves on 18471
    d.start_viewer(str(png), interval=0.1, http_port=port)
    d.update()
    d.set_pos_dir(0, 0, 0, 0, 0, 1)
    deadline = time.time() + 20
    while not png.exists() and time.time() < deadline:
        time.sleep(0.2)
    assert png.exists(), "viewer thread produced no render"
    deadline = time.time() + 10
    body = b""
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/map.png", timeout=2) as r:
                body = r.read()
            break
        except Exception:
            time.sleep(0.2)
    assert body.startswith(b"\x89PNG")
    d.stop()
    assert d._viewer_thread is None


# ---------------------------------------------------------------------------
# twin maps


def _port_map():
    """A port map: 4 keyframes with rendered images along a lateral path,
    60 map points observed by 2-4 of them with subpixel measurements and
    octave weights, a culled point, a culled keyframe and two outlier
    flags."""
    pmm.reset_map_ids()
    pframe.reset_frame_ids()
    rng = np.random.default_rng(11)
    world = sim.PlaneWorld(width=W, height=H, f=F)
    poses = sim.lateral_trajectory(5, step=0.1)
    map_ = pmm.Map(use_native_graph=False)
    kfs = []
    for i, T in enumerate(poses):
        fr = pframe.Frame(world.render(T), 0.1 * i, K_MAT)
        fr.set_pose(T)
        kf = pmm.KeyFrame(fr, map_, None)
        map_.add_keyframe(kf)
        kfs.append(kf)
    map_.keyframe_origins.append(kfs[0])
    mps = []
    for j in range(60):
        pos = np.array([rng.uniform(-1, 1), rng.uniform(-0.7, 0.7), rng.uniform(4, 6)],
                       np.float32)
        mp = pmm.MapPoint(pos, kfs[0], map_)
        for k in sorted(rng.choice(4, rng.integers(2, 5), replace=False)):
            T = poses[k]
            Xc = T[:3, :3] @ pos + T[:3, 3]
            uv = K_MAT[:2, :2] @ (Xc[:2] / Xc[2]) + K_MAT[:2, 2]
            px = (int(uv[0]), int(uv[1]))
            meas = (float(uv[0]), float(uv[1]))
            info = float(1.2 ** (-2.0 * (j % 3)))
            kfs[k].keypoint_map.set_map_point(px, mp, measurement=meas, info=info)
            mp.add_observation(kfs[k], px, measurement=meas, info=info)
        mp.update_normal_and_depth()
        mp.increase_visible(3 + j % 4)
        mp.increase_found(1 + j % 3)
        map_.add_map_point(mp)
        mps.append(mp)
    for kf in kfs:
        kf.update_connections()
    mps[7].set_bad_flag()
    kfs[4].set_bad_flag()
    for kf in kfs[1:3]:
        idx = next(iter(kf.keypoint_map.indices()))
        kf.keypoint_map.set_outlier(idx, True)
    return map_


@pytest.fixture(scope="module")
def snap():
    return convert.snapshot_map(_port_map())


def test_drawer_update_equals_jax(snap):
    pmap, _, _ = convert.map_from_snapshot(snap, classes=PORT_CLASSES)
    jmap, _, _ = convert.map_from_snapshot(snap, classes=JAX_CLASSES)
    p, j = MapDrawer(pmap), JDrawer(jmap)
    p.update()
    j.update()
    assert p.points.shape == (59, 3) and p.kf_centers.shape == (4, 3)
    for k in ("points", "kf_centers", "kf_dirs"):
        np.testing.assert_array_equal(getattr(p, k), getattr(j, k))


def _summary(map_):
    """What a checkpoint carries, by id, read through either package's
    accessors."""
    def r(a, n=4):
        return tuple(np.round(np.asarray(a, np.float64), n).tolist())

    kfs = {kf.id: (kf.frame_id, kf.timestamp, r(kf.Tcw.ravel(), 6),
                   None if kf.parent is None else kf.parent.id,
                   sorted((i, it.map_point.id, r(it.measurement), round(float(it.info), 6),
                           bool(it.outlier)) for i, it in kf.keypoint_map.items()))
           for kf in map_.all_keyframes() if not kf.is_bad}
    mps = {mp.id: (r(mp.world_pos, 6), r(mp.normal, 6), round(float(mp.distance), 5),
                   mp.n_found, mp.n_visible, mp.first_kf_id,
                   None if mp.ref_kf is None else mp.ref_kf.id,
                   sorted((kf.id, tuple(kp), r(mp.measurement_in_keyframe(kf)),
                           round(float(mp.info_in_keyframe(kf)), 6))
                          for kf, kp in mp.observations.items()))
           for mp in map_.all_map_points() if not mp.is_bad}
    return kfs, mps, [kf.id for kf in map_.keyframe_origins]


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_checkpoint_loads_across_packages(snap, tmp_path, writer, reader):
    """A file written by `writer` from its twin map, loaded by `reader`,
    holds what the JAX package's own save/load round trip holds."""
    path = str(tmp_path / "map.npz")
    j_ref = str(tmp_path / "ref.npz")
    jmap_src, _, _ = convert.map_from_snapshot(snap, classes=JAX_CLASSES)
    jckpt.save_map(j_ref, jmap_src)
    want = jmm.Map(use_native_graph=False)
    jckpt.load_map(j_ref, want, None, None)
    if writer == "port":
        pckpt.save_map(path, convert.map_from_snapshot(snap, classes=PORT_CLASSES)[0])
    else:
        jckpt.save_map(path, jmap_src)
    if reader == "port":
        got = pmm.Map(use_native_graph=False)
        pckpt.load_map(path, got, None, None)
    else:
        got = jmm.Map(use_native_graph=False)
        jckpt.load_map(path, got, None, None)
    kfs, mps, origins = _summary(got)
    assert len(kfs) == 4 and len(mps) == 59 and origins == [0]
    assert (kfs, mps, origins) == _summary(want)
    n_out = sum(o for kf in kfs.values() for *_, o in kf[4])
    assert n_out == 2
