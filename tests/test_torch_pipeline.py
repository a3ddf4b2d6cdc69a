"""The port's System on its own, on the CPU: tests/test_pipeline.py's
28-frame sequence (320x240, 400 features, step 0.07) through
chip_smoke.run_system, held to that test's own bounds: OK on all but at most
4 frames after the first OK, >= 2 keyframes, > 50 map points, keyframe ATE
< 0.15 and early per-frame ATE < 0.05 (scale-aligned, from the TUM
exports). Also the public API around it (match image, metrics, reset), the
initialization gate, the entry points' default device, and the map drawer
(updated on every OK frame), start_gui / stop_gui and test_pipeline.py's
checkpoint round trip on the tracked map.
"""

import inspect
import time

import numpy as np
import pytest
import torch

import chip_smoke
import torch_parity  # noqa: F401  (pins torch to one thread)
from mono_slam_framework_torch import convert
from mono_slam_framework_torch.io import trajectory
from mono_slam_framework_torch.matchers import LoftrFeatureMatcher, OrbFeatureMatcher
from mono_slam_framework_torch.params import SlamParameters
from mono_slam_framework_torch.slam import KeyFrameMatchDatabase, System
from mono_slam_framework_torch.slam.tracking import TrackingState

CPU = torch.device("cpu")
CFG = chip_smoke.SYSTEM_SMALL


def _system(world, **params):
    return System(
        SlamParameters(fx=world.f, fy=world.f, cx=world.cx, cy=world.cy,
                       max_features=400, minIniMatchCount=100, **params),
        OrbFeatureMatcher(threshold=0.7, max_features=400, device="cpu"),
        KeyFrameMatchDatabase(None), verbose=False, device="cpu",
    )


@pytest.fixture(scope="module")
def run():
    world, poses, images = chip_smoke.render_system(CFG)
    return world, poses, chip_smoke.run_system(CPU, CFG, world, poses, images)


def test_tracks_the_synthetic_sequence(run, tmp_path):
    world, poses, r = run
    states = r["states"]
    n = len(states)
    assert n == 28 and "OK" in states
    first = states.index("OK")
    assert sum(s == "OK" for s in states[first:]) >= (n - first) - 4, states
    system = r["system"]
    assert system.map.n_keyframes() >= 2
    assert system.map.n_map_points() > 50
    assert r["launches"] == {"b1": 0, "b2": 0}  # the CPU runs the plain versions

    gt_t = np.arange(n) * 0.1
    gt_p = np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in poses])
    system.save_keyframe_trajectory_tum(str(tmp_path / "kf.txt"))
    t_est, p_est, q_est = trajectory.read_tum(str(tmp_path / "kf.txt"))
    ate, n_assoc = trajectory.ate_rmse(t_est, p_est, gt_t, gt_p)
    assert n_assoc >= 2 and ate < 0.15, ate
    np.testing.assert_allclose(np.linalg.norm(q_est, axis=1), 1.0, atol=1e-5)
    system.save_trajectory_tum(str(tmp_path / "frames.txt"))
    t_fr, p_fr, _ = trajectory.read_tum(str(tmp_path / "frames.txt"))
    assert len(t_fr) >= 12
    ate_early, n_early = trajectory.ate_rmse(t_fr[:12], p_fr[:12], gt_t, gt_p)
    assert n_early >= 6 and ate_early < 0.05, ate_early
    # run_system's own ATE (live poses) agrees with the exports'
    assert abs(r["ate_kf"] - ate) < 1e-4


def test_gui_and_checkpoints_work(run, tmp_path):
    """The map drawer on the tracked map (updated on every OK frame, as the
    JAX tracker does), start_gui / stop_gui with the live viewer, and
    test_pipeline.py:108-122's checkpoint round trip on the port."""
    world, _, r = run
    system = r["system"]
    assert system.params.fusedTracking is False  # run_system's default flow
    drawer = system.map_drawer
    assert system.tracker.map_drawer is drawer
    # one camera position per OK frame after the one that initialized (that
    # frame only snapshots the map, Tracking.cc:113)
    assert len(drawer.history) == r["states"].count("OK") - 1
    assert drawer.points.shape == (system.map.n_map_points(), 3)
    png = tmp_path / "live.png"
    system.start_gui(str(png), interval=0.05)
    assert drawer.running and drawer._viewer_thread is not None
    drawer.update()
    deadline = time.time() + 20
    while not png.exists() and time.time() < deadline:
        time.sleep(0.1)
    system.stop_gui()
    assert png.exists() and not drawer.running and drawer._viewer_thread is None

    n_kf = system.map.n_keyframes()
    n_mp = system.map.n_map_points()
    path = str(tmp_path / "map.npz")
    system.save_checkpoint(path)
    system2 = _system(world)
    system2.load_checkpoint(path)
    assert system2.map.n_keyframes() == n_kf
    assert system2.map.n_map_points() >= 0.8 * n_mp
    kf_l = sorted(system2.map.all_keyframes(), key=lambda k: k.id)[0]
    kf_o = sorted(system.map.all_keyframes(), key=lambda k: k.id)[0]
    np.testing.assert_allclose(kf_l.Tcw, kf_o.Tcw, atol=1e-6)
    assert kf_l.keypoint_map.size > 0
    assert len(system2.kf_db.frames) == n_kf


def test_public_api_and_reset(run):
    world, _, r = run
    system = r["system"]
    assert system.get_current_position() is not None
    img = system.get_current_match_image()
    assert img.shape == (world.h, 2 * world.w, 3) and img.dtype == np.uint8
    assert system.last_metrics["state"] == r["states"][-1]
    assert system.last_metrics["n_mp"] == system.map.n_map_points()
    assert len(system.get_all_map_points()) == system.map.n_map_points()
    assert set(system.timer.totals) == {"tracking", "local_mapping", "loop_closing"}
    assert system.map_changed() is False
    system.map.inform_new_big_change()
    assert system.map_changed() is True
    system.reset()
    assert system.map.n_map_points() == 0
    assert system.map.n_keyframes() == 0
    assert system.tracker.state == TrackingState.NO_IMAGES_YET
    assert len(system.kf_db.frames) == 0
    assert system.tracker.relative_frame_poses == []


def test_initialization_gate():
    """Gate not toggled: the System never initializes."""
    world, poses, images = chip_smoke.render_system(CFG._replace(n_warm=0, n_timed=6, step=0.1))
    system = chip_smoke.build_system(CPU, CFG, world)
    for i, img in enumerate(images):
        system.track_monocular(img, timestamp=i * 0.1)
    assert system.map.n_map_points() == 0
    assert system.tracker.state == TrackingState.NOT_INITIALIZED


def test_entry_points_default_to_the_card():
    entry_points = [OrbFeatureMatcher.__init__, LoftrFeatureMatcher.__init__, System.__init__,
                    convert.features_from_numpy, convert.loftr_params,
                    convert.steady_inputs_from_numpy, convert.ba_problem_from_numpy]
    for fn in entry_points:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if torch.cuda.is_available():
        return  # asking for the card succeeds there
    with pytest.raises(RuntimeError, match="no CUDA card"):
        OrbFeatureMatcher()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        System(SlamParameters(fusedTracking=False), None, KeyFrameMatchDatabase(None))
    f = {"xy": np.zeros((2, 2)), "angle": np.zeros(2), "desc": np.zeros((2, 8), np.uint32),
         "score": np.zeros(2), "valid": np.ones(2, bool), "octave": np.zeros(2)}
    with pytest.raises(RuntimeError, match="no CUDA card"):
        convert.features_from_numpy(f)


def test_system_refuses_another_device_than_its_matcher():
    with pytest.raises(ValueError, match="same device"):
        System(SlamParameters(fusedTracking=False),
               OrbFeatureMatcher(device="cpu"), KeyFrameMatchDatabase(None),
               device="meta")


