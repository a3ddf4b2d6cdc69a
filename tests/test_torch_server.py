"""Port parity for multi-stream serving (mono_slam_framework_torch/parallel/
server.py::SlamServer), held to tests/test_server.py's bounds: N full port
Systems served per tick with their steady frames batched, each stream
behaving as an independently run port System on the same frames (all OK,
ATE < 0.15 against ground truth, trajectory pair < 0.05), the batched call
serving a share of the run (batch_groups >= 3, every batched dispatch
consumed), streams isolated, a None image skipping its stream, and the
one-tick-latency `step_pipelined` / `flush`. Then the server's side of the
speculative dispatch: `fused_host.prepare_spec_inputs` gives the fields of
the JAX package's.

test_server.py's world (320x240), 18 frames, 400 features, 2 streams with
test_server.py's steps 0.048 and 0.056 (its third stream is left out to keep
the file's time down), all on the CPU.
"""

import inspect
import re

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch to one thread)
from mono_slam_framework_tpu.slam import fused_host as jfused_host
from mono_slam_framework_torch import sim
from mono_slam_framework_torch.io import trajectory
from mono_slam_framework_torch.matchers import OrbFeatureMatcher
from mono_slam_framework_torch.parallel import SlamServer
from mono_slam_framework_torch.params import SlamParameters
from mono_slam_framework_torch.slam import KeyFrameMatchDatabase, System, fused_host
from mono_slam_framework_torch.slam.frame import reset_frame_ids
from mono_slam_framework_torch.slam.map_model import reset_map_ids
from mono_slam_framework_torch.slam.tracking import TrackingState

N_STREAMS = 2
N_FRAMES = 18
MAXF = 400


def _params(world):
    return SlamParameters(
        fx=world.f, fy=world.f, cx=world.cx, cy=world.cy,
        max_features=MAXF, minIniMatchCount=100,
        initializerModelFallback=True, fusedTracking=True, fusedOneStep=True,
    )


def _matcher():
    return OrbFeatureMatcher(threshold=0.7, max_features=MAXF, device="cpu")


def _server(world):
    reset_frame_ids()
    reset_map_ids()
    server = SlamServer(_params(world), _matcher, N_STREAMS, device="cpu")
    for system in server.systems:
        system.toggle_initialization_allowed()
    return server


def _hits(server) -> int:
    return sum(fused_host.pipe_stats(s.tracker).get("hit", 0) for s in server.systems)


def _ate(system, traj, tmp_path, name):
    path = str(tmp_path / f"{name}.txt")
    system.save_trajectory_tum(path)
    t, p, _ = trajectory.read_tum(path)
    gt_t = np.array([i * 0.1 for i in range(N_FRAMES)])
    gt_p = np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in traj])
    return trajectory.ate_rmse(t, p, gt_t, gt_p), (t, p)


@pytest.fixture(scope="module")
def runs():
    world = sim.PlaneWorld(second_plane=(3.0, 0.3))
    trajs = [sim.lateral_trajectory(N_FRAMES, step=0.048 + 0.008 * s) for s in range(N_STREAMS)]
    frames = [[world.render(T) for T in poses] for poses in trajs]

    # independent single-stream references on the same frames
    refs = []
    for s in range(N_STREAMS):
        reset_frame_ids()
        reset_map_ids()
        m = _matcher()
        system = System(_params(world), m, KeyFrameMatchDatabase(m), verbose=False,
                        rng_seed=s, device="cpu")
        system.toggle_initialization_allowed()
        for i in range(N_FRAMES):
            system.track_monocular(frames[s][i], timestamp=i * 0.1)
        refs.append(system)

    # the server run: one tick per frame index across all streams
    server = _server(world)
    for i in range(N_FRAMES):
        server.step([frames[s][i] for s in range(N_STREAMS)], timestamps=i * 0.1)
    return world, trajs, frames, refs, server


def test_all_streams_track(runs):
    *_, server = runs
    for system in server.systems:
        assert system.tracker.state == TrackingState.OK
        assert system.map.n_keyframes() >= 2


def test_batched_dispatch_engaged(runs):
    *_, server = runs
    st = server.stats
    assert st["batch_groups"] >= 3, st
    assert st["batched_frames"] >= 2 * N_STREAMS, st
    # every batched dispatch was consumed by run_steady's spec branch
    assert _hits(server) >= st["batched_frames"], st
    assert st["ticks"] == N_FRAMES and st["frames"] == N_FRAMES * N_STREAMS
    assert len(st["prepare_samples_ms"]) == N_FRAMES
    assert len(st["readback_samples_ms"]) == st["batch_groups"]


def test_streams_match_independent_systems(runs, tmp_path):
    _, trajs, _, refs, server = runs
    for s in range(N_STREAMS):
        (ate_r, _), _ = _ate(refs[s], trajs[s], tmp_path, f"ref{s}")
        (ate_v, _), (t_v, p_v) = _ate(server.systems[s], trajs[s], tmp_path, f"srv{s}")
        assert ate_r < 0.15 and ate_v < 0.15, (s, ate_r, ate_v)
        _, (t_r, p_r) = _ate(refs[s], trajs[s], tmp_path, f"ref{s}")
        ate_pair, n = trajectory.ate_rmse(t_v, p_v, t_r, p_r)
        assert n >= 8, (s, n)
        assert ate_pair < 0.05, (s, ate_pair)


def test_streams_are_isolated(runs):
    *_, server = runs
    centers = [s.tracker.current_frame.get_camera_center() for s in server.systems]
    assert not np.allclose(centers[0], centers[-1], atol=1e-3)
    assert all(s.map.n_keyframes() >= 2 for s in server.systems)
    maps = [s.map for s in server.systems]
    assert len({id(m) for m in maps}) == N_STREAMS


def test_prepare_spec_inputs_gives_the_jax_fields(runs):
    """On a stream in the steady state, the prepared inputs carry the JAX
    package's fields (its return dict in fused_host.prepare_spec_inputs):
    kind, statics with the same names, T_prev_host on the host, and a key
    that depends on the statics and the image shape, not on table sizes."""
    world, trajs, *_, server = runs
    src = inspect.getsource(jfused_host.prepare_spec_inputs)
    ret = src[src.rindex("return {"):]
    jax_fields = set(re.findall(r'^ {8}"(\w+)":', ret, re.M))
    jax_statics = set(re.findall(r'^ {8}"(\w+)":', src[src.index("statics = {"):src.index("return {")], re.M))
    system = server.systems[0]
    tr = system.tracker
    img = world.render(trajs[0][-1])
    prep = fused_host.prepare_spec_inputs(tr, img)
    assert prep is not None, fused_host.pipe_stats(tr)
    assert jax_fields <= set(prep), jax_fields - set(prep)
    assert set(prep["statics"]) == jax_statics
    assert prep["kind"] == "orb" and isinstance(prep["T_prev_host"], np.ndarray)
    assert prep["key"] == ("orb", tuple(sorted(prep["statics"].items())), img.shape)
    assert prep["statics"]["max_features"] == MAXF and prep["statics"]["cols"] == 320
    # preparing mutates no tracking state: a dispatch from it is consumable
    tr._pipe_spec = fused_host.dispatch_prepared(tr, prep)
    hits = fused_host.pipe_stats(tr)["hit"]
    system.track_monocular(img, timestamp=N_FRAMES * 0.1)
    assert fused_host.pipe_stats(tr)["hit"] == hits + 1


def test_none_image_skips_stream(runs):
    world, trajs, _, _, server = runs
    before = [s.tracker.current_frame.id for s in server.systems]
    out = server.step(
        [None] + [world.render(trajs[s][-1]) for s in range(1, N_STREAMS)],
        timestamps=(N_FRAMES + 1) * 0.1,
    )
    assert out[0] is None
    assert server.systems[0].tracker.current_frame.id == before[0]
    assert server.systems[1].tracker.current_frame.id != before[1]


def test_step_pipelined(runs, tmp_path):
    """One-tick-latency serving: tick N's batched call is dispatched at the
    end of tick N's call and replayed at tick N+1."""
    world, trajs, frames, _, _ = runs
    server = _server(world)
    outs = [server.step_pipelined([frames[s][i] for s in range(N_STREAMS)], timestamps=i * 0.1)
            for i in range(N_FRAMES)]
    final = server.flush()
    assert all(o is None for o in outs[0])
    assert any(o is not None for o in final)
    for s in range(N_STREAMS):
        assert server.systems[s].tracker.state == TrackingState.OK
        (ate_v, n), _ = _ate(server.systems[s], trajs[s], tmp_path, f"pipe{s}")
        assert n >= 10, (s, n)
        assert ate_v < 0.15, (s, ate_v)
    assert server.stats["batch_groups"] >= 3, server.stats
    assert _hits(server) >= server.stats["batched_frames"], server.stats


def test_server_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    world = sim.PlaneWorld()
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamServer(_params(world), _matcher, 1)
