"""Port parity: the public matcher plugin API (OrbFeatureMatcher.match_frames
and match_against_many) against the JAX package's, on two rendered views.

The integer keypoint pairs must agree as sets (>= 95 %: top-k ties and
pyramid float reassociation move a few features); the ratio test is strict
'<' on both sides.
"""

import numpy as np
import pytest

import torch_parity  # noqa: F401  (pins torch to one thread)
from mono_slam_framework_tpu.matchers import OrbFeatureMatcher as JaxOrbMatcher
from mono_slam_framework_torch import sim
from mono_slam_framework_torch.matchers import MatchFramesResult, OrbFeatureMatcher


class _Frame:  # minimal frame stand-in: an image and a cache key
    def __init__(self, key, image):
        self.matcher_key = key
        self.image = image


@pytest.fixture(scope="module")
def frames():
    world = sim.PlaneWorld(width=320, height=240, f=250.0, second_plane=(3.0, 0.3))
    poses = sim.lateral_trajectory(3, step=0.05)
    return [_Frame(i, world.render(T)) for i, T in enumerate(poses)]


@pytest.fixture(scope="module")
def results(frames):
    port = OrbFeatureMatcher(threshold=0.7, max_features=400, device="cpu")
    ref = JaxOrbMatcher(threshold=0.7, max_features=400)
    return port, port.match_frames(frames[0], frames[1]), ref.match_frames(frames[0], frames[1])


def _pairs(r: MatchFramesResult):
    return {tuple(a) + tuple(b) for a, b in zip(r.keypoints1.tolist(), r.keypoints2.tolist())}


def test_match_frames_agrees_with_jax(results):
    _, got, ref = results
    assert isinstance(got, MatchFramesResult)
    assert got.keypoints1.dtype == np.int32 and got.keypoints2.dtype == np.int32
    assert got.keypoints1.shape == got.keypoints2.shape
    assert got.num_matches > 50
    a, b = _pairs(got), _pairs(ref)
    assert len(a & b) >= 0.95 * max(len(a), len(b)), (len(a & b), len(a), len(b))
    # the subpixel coordinates truncate to the integer contract
    np.testing.assert_array_equal(got.keypoints1_f.astype(np.int32), got.keypoints1)
    np.testing.assert_array_equal(got.octaves1.shape, (got.num_matches,))


def test_match_against_many_matches_pairwise(results, frames):
    port, single, _ = results
    many = port.match_against_many(frames[0], [frames[1], frames[2], frames[1]])
    assert len(many) == 3
    np.testing.assert_array_equal(many[0].keypoints1, single.keypoints1)
    np.testing.assert_array_equal(many[0].keypoints2, single.keypoints2)
    np.testing.assert_array_equal(many[2].keypoints2, single.keypoints2)
    other = port.match_frames(frames[0], frames[2])
    np.testing.assert_array_equal(many[1].keypoints2, other.keypoints2)
    assert port.match_against_many(frames[0], []) == []


def test_ratio_threshold_is_strict(frames):
    # threshold 0 accepts nothing (best < 0 * second never holds), and a
    # looser threshold never accepts fewer matches
    m = OrbFeatureMatcher(threshold=0.0, max_features=400, device="cpu")
    assert m.match_frames(frames[0], frames[1]).num_matches == 0
    m.set_threshold(0.9)
    assert m.match_frames(frames[0], frames[1]).num_matches > 50
