"""The traffic is made from the seed alone, and the world renders as the
simulator it was copied from."""

from __future__ import annotations

import numpy as np
import torch

from mono_slam_framework_torch import sim
from slam_bench import harness, manifest, world

from .conftest import SMALL_ORB

CPU = torch.device("cpu")


def _traffic(name, run_seed, frames=6, spec_keys=None, **world_keys):
    spec = {**manifest.load_json(manifest.traffic_file(name)), **(spec_keys or {})}
    spec = {**spec, "frames": frames, "world": {**spec["world"], **world_keys,
                                                "texture": {"size": 512, "scale": 100.0, "squares": 50}}}
    config = {**manifest.load_json(manifest.config_file("orb_tum640")), **SMALL_ORB}
    return harness.Traffic(spec, config, run_seed, CPU)


def test_same_seed_same_frames():
    bands = {"bands": {"start": -1.0, "stop": 1.0, "spacing": 0.5, "depths": [3.0, 4.0]}}
    for spec_keys, world_keys in (({}, {}), ({"streams": 2, "stream_offset": 3}, {}), ({}, bands)):
        a, b = (_traffic("sweep", 2**31 + 12345, spec_keys=spec_keys, **world_keys) for _ in range(2))
        for s in range(a.streams):
            assert all(np.array_equal(x, y) for x, y in zip(a.frames[s], b.frames[s]))


def test_the_mix_fixes_its_world():
    """Every run seed meets the same world (the same work); a world without
    a seed of its own follows the run seed."""
    a, b = _traffic("sweep", 1), _traffic("sweep", 2)
    assert np.array_equal(a.frames[0][0], b.frames[0][0])
    a, b = _traffic("sweep", 1, seed=None), _traffic("sweep", 2, seed=None)
    assert not np.array_equal(a.frames[0][0], b.frames[0][0])


def test_streams_differ_and_follow_their_offset():
    t = _traffic("sweep", 7, frames=240, spec_keys={"streams": 2, "stream_offset": 60})
    assert not np.array_equal(t.frames[0][0], t.frames[1][0])
    np.testing.assert_array_equal(t.poses[1][0], t.poses[0][60])
    np.testing.assert_array_equal(t.pose(1, 0), t.poses[0][60])


def test_render_matches_the_simulator():
    """The torch renderer against sim.PlaneWorld.render on one texture."""
    ref = sim.PlaneWorld(width=160, height=120, f=125.0, second_plane=(3.0, 0.3), tex_size=512, seed=3)
    w = world.World(160, 120, 125.0, 125.0, ref.cx, ref.cy, ref.plane_z, ref.extra_planes, ref.tex,
                    ref.tex_scale, CPU)
    poses = sim.lateral_trajectory(5, step=0.05)
    got = w.render(np.stack(poses)).numpy()
    for g, T in zip(got, poses):
        np.testing.assert_allclose(g, ref.render(T), atol=2e-3)


def test_seeds_past_32_bits_and_negative():
    for seed in (2**31 + 7, 2**40, -5):
        assert world.rng_for(seed, 1).integers(0, 10, 3).shape == (3,)
