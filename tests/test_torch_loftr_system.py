"""The port's System with the LoFTR matcher, on the CPU, over
tests/test_loftr_pipeline.py's drives (640x480, PlaneWorld(second_plane=
(3.0, 0.3)), lateral_trajectory(step=0.12), LoftrFeatureMatcher(threshold=0.1),
minIniMatchCount=60, initializerModelFallback=True), held to that file's
bounds; the JAX System is never run here:

  * the fine 10-frame run in the reference-twin flow: OK from frame 1 or 2
    on and never lost, >= 4 keyframes, > 200 map points, frame ATE < 0.2
    over >= 6 frames;
  * coarse, fused (slam/fused_loftr.py) against unfused over 8 frames:
    equal states, OK reached, >= 2 keyframes, trajectory pair ATE < 0.06
    over >= 5 frames, and the fused flow's steady frames completed by
    fused_loftr.run_steady;
  * the pipelined mode (track_monocular_pipelined + flush_pipeline) ends OK,
    with a frame ATE < 0.2, and every dispatch accounted for. At step 0.12
    a keyframe is inserted on most frames, so the window changes between
    dispatch and consumption and a dispatch is rarely possible; the same
    drive at step 0.05 over 12 frames consumes at least 2 speculative
    steps (hits).

With the model, matcher and fused-core parity of test_torch_loftr_model.py,
test_torch_loftr_matcher.py and test_torch_fused_loftr.py, this holds the
LoFTR System to the JAX package's.
"""

import numpy as np
import pytest

import torch_parity  # noqa: F401  (pins torch to one thread)
from mono_slam_framework_torch import sim
from mono_slam_framework_torch.io import trajectory
from mono_slam_framework_torch.matchers import LoftrFeatureMatcher
from mono_slam_framework_torch.params import SlamParameters
from mono_slam_framework_torch.slam import KeyFrameMatchDatabase, System, fused_host
from mono_slam_framework_torch.slam.frame import reset_frame_ids
from mono_slam_framework_torch.slam.map_model import reset_map_ids
from mono_slam_framework_torch.slam.tracking import TrackingState

WORLD = sim.PlaneWorld(width=640, height=480, f=500.0, second_plane=(3.0, 0.3))


def build_loftr_system(fine: bool, fused: bool = True) -> System:
    """test_loftr_pipeline.build_loftr_system on the port, on the CPU."""
    reset_frame_ids()
    reset_map_ids()
    params = SlamParameters(
        fx=WORLD.f, fy=WORLD.f, cx=WORLD.cx, cy=WORLD.cy, minIniMatchCount=60,
        initializerModelFallback=True, fusedTracking=fused, fusedOneStep=fused,
    )
    matcher = LoftrFeatureMatcher(threshold=0.1, fine=fine, device="cpu")
    return System(params, matcher, KeyFrameMatchDatabase(matcher), verbose=False,
                  device="cpu")


def _drive(system, poses, pipelined=False):
    system.toggle_initialization_allowed()
    states = []
    for i, T in enumerate(poses):
        img = WORLD.render(T)
        if pipelined:
            system.track_monocular_pipelined(img, i * 0.1)
        else:
            system.track_monocular(img, i * 0.1)
            states.append(system.tracker.state)
    if pipelined:
        system.flush_pipeline()
    return states


def _tum(system, tmp_path, tag):
    p = tmp_path / f"{tag}.txt"
    system.save_trajectory_tum(str(p))
    return trajectory.read_tum(str(p))[:2]


def _gt(poses):
    return (np.arange(len(poses)) * 0.1,
            np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in poses]))


@pytest.fixture(scope="module")
def fine_run():
    poses = sim.lateral_trajectory(10, step=0.12)
    system = build_loftr_system(fine=True, fused=True)
    return system, _drive(system, poses), poses


def test_fine_run_initializes_and_grows(fine_run):
    system, states, _ = fine_run
    assert states[1] == TrackingState.OK or states[2] == TrackingState.OK
    first_ok = states.index(TrackingState.OK)
    assert all(s == TrackingState.OK for s in states[first_ok:]), [s.name for s in states]
    assert system.map.n_keyframes() >= 4
    assert system.map.n_map_points() > 200
    # the fine stage keeps the flow on the host path (fused_loftr.applicable)
    assert fused_host.pipe_stats(system.tracker).get("done_steady", 0) == 0


def test_fine_run_trajectory(fine_run, tmp_path):
    system, _, poses = fine_run
    ate, n_assoc = trajectory.ate_rmse(*_tum(system, tmp_path, "fine"), *_gt(poses))
    assert n_assoc >= 6
    assert ate < 0.2, ate


def test_fused_steady_matches_unfused(tmp_path):
    poses = sim.lateral_trajectory(8, step=0.12)
    sys_u = build_loftr_system(fine=False, fused=False)
    st_u = _drive(sys_u, poses)
    tum_u = _tum(sys_u, tmp_path, "u")
    sys_f = build_loftr_system(fine=False, fused=True)
    st_f = _drive(sys_f, poses)
    assert [s.name for s in st_f] == [s.name for s in st_u]
    assert TrackingState.OK in st_f
    assert sys_f.map.n_keyframes() >= 2
    stats = fused_host.pipe_stats(sys_f.tracker)
    assert stats.get("done_steady", 0) >= 3, stats
    # each steady step's three model calls (encode, two confidences) run
    # eagerly on the CPU: no CUDA graph
    assert stats["loftr_eager"] >= 3 * stats["done_steady"] and stats["loftr_eager"] % 3 == 0
    assert stats["loftr_graph_replay"] == stats["loftr_graph_capture"] == 0, stats
    assert "done_steady" not in fused_host.pipe_stats(sys_u.tracker)
    ate_pair, n = trajectory.ate_rmse(*_tum(sys_f, tmp_path, "f"), *tum_u)
    assert n >= 5
    assert ate_pair < 0.06, ate_pair


@pytest.mark.parametrize("step,n,min_hits", [(0.12, 8, 0), (0.05, 12, 2)])
def test_pipelined_loftr(tmp_path, step, n, min_hits):
    poses = sim.lateral_trajectory(n, step=step)
    system = build_loftr_system(fine=False, fused=True)
    _drive(system, poses, pipelined=True)
    assert system.tracker.state == TrackingState.OK
    stats = fused_host.pipe_stats(system.tracker)
    misses = sum(v for k, v in stats.items() if k.startswith("miss_"))
    skips = sum(v for k, v in stats.items() if k.startswith("skip_"))
    assert stats["hit"] + misses <= stats["dispatch"]
    assert stats["dispatch"] + skips == len(poses)
    assert stats["hit"] >= min_hits, stats
    ate, n_assoc = trajectory.ate_rmse(*_tum(system, tmp_path, "pipe"), *_gt(poses))
    assert n_assoc >= 5
    assert ate < 0.2, ate
