"""The port's System on its own, on the CPU: tests/test_pipeline.py's
28-frame sequence (320x240, 400 features, step 0.07) through
chip_smoke.run_system, held to that test's own bounds: OK on all but at most
4 frames after the first OK, >= 2 keyframes, > 50 map points, keyframe ATE
< 0.15 and early per-frame ATE < 0.05 (scale-aligned, from the TUM
exports). Also the public API around it (match image, metrics, reset), the
initialization gate, the entry points' default device, and what this slice
refuses with NotImplementedError.
"""

import inspect

import numpy as np
import pytest
import torch

import chip_smoke
import torch_parity  # noqa: F401  (pins torch to one thread)
from mono_slam_framework_torch import convert
from mono_slam_framework_torch.io import trajectory
from mono_slam_framework_torch.matchers import OrbFeatureMatcher
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
    entry_points = [OrbFeatureMatcher.__init__, System.__init__, convert.features_from_numpy,
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


def test_unported_paths_raise():
    world = chip_smoke.sim.PlaneWorld()
    with pytest.raises(NotImplementedError, match="fusedTracking"):
        _system(world, fusedTracking=True)
    # SlamParameters' default is the fused flow: refused as well
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _system(world)
    system = _system(world, fusedTracking=False)
    with pytest.raises(NotImplementedError, match="relocalization"):
        system.tracker.relocalization()
    with pytest.raises(NotImplementedError, match="loop correction"):
        system.loop_closer.correct_loop()
    with pytest.raises(NotImplementedError, match="MapDrawer"):
        system.start_gui()
    with pytest.raises(NotImplementedError, match="checkpoint"):
        system.save_checkpoint("unused")
    with pytest.raises(NotImplementedError, match="checkpoint"):
        system.load_checkpoint("unused")
