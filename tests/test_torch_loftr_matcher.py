"""Port parity for the LoFTR matcher (matchers/loftr_matcher.py).

On tests/test_loftr.py's rendered 640x480 pair, the port's
LoftrFeatureMatcher(device="cpu") gives the JAX matcher's match set: the same
integer keypoints and octaves (as sets of rows; both keep the top-k above
the threshold), and with the fine stage the same float keypoints within
1e-3 px while the integer keypoints stay at the cell corners. Frames of
another size go through the port's resize, held to jax.image.resize
(bilinear, antialiased) within 1e-3 grey levels at 320x240 (upsampled) and
800x600 (downsampled). Also the feature cache, the batched database match
against serial calls, set_threshold, and the default device.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch to one thread)
from mono_slam_framework_tpu.matchers.loftr_matcher import LoftrFeatureMatcher as JMatcher
from mono_slam_framework_torch.matchers import LoftrFeatureMatcher
from mono_slam_framework_torch.matchers import loftr_matcher as plm

from synthetic_world import PlaneWorld, lateral_trajectory


class _F:
    def __init__(self, i, img):
        self.id, self.image, self.matcher_key = i, img, ("L", i)


@pytest.fixture(scope="module")
def pair():
    world = PlaneWorld(width=640, height=480, f=500.0, second_plane=(3.0, 0.3))
    poses = lateral_trajectory(4, step=0.2)
    return world.render(poses[0]), world.render(poses[2])


def _rows(res, *fields):
    """The result's rows (x1, y1, x2, y2, ...) in a canonical order."""
    cols = [res.keypoints1, res.keypoints2] + [getattr(res, f) for f in fields]
    a = np.concatenate([np.asarray(c, np.float64).reshape(len(res.keypoints1), -1)
                        for c in cols], axis=1)
    return a[np.lexsort(a[:, :4].T[::-1])]


@pytest.mark.parametrize("scale", [1, 2])
def test_match_frames_equals_jax(pair, scale):
    """scale 2: both frames at 320x240, through the resize and the decode's
    image/model scale."""
    a, b = (np.ascontiguousarray(im[::scale, ::scale]) for im in pair)
    ref = JMatcher(threshold=0.15).match_frames(_F(0, a), _F(1, b))
    got = LoftrFeatureMatcher(threshold=0.15, device="cpu").match_frames(_F(0, a), _F(1, b))
    assert got.num_matches == ref.num_matches > 5
    assert got.keypoints1.dtype == np.int32
    np.testing.assert_array_equal(_rows(got, "octaves1", "octaves2"),
                                  _rows(ref, "octaves1", "octaves2"))
    if scale == 1:
        assert (got.keypoints1 % 16 == 0).all() and (got.keypoints2 % 16 == 0).all()
    assert got.keypoints1_f is None


def test_fine_stage_equals_jax(pair):
    a, b = pair
    ref = JMatcher(threshold=0.15, fine=True).match_frames(_F(0, a), _F(1, b))
    m = LoftrFeatureMatcher(threshold=0.15, fine=True, device="cpu")
    got = m.match_frames(_F(0, a), _F(1, b))
    assert got.num_matches == ref.num_matches > 5
    g, r = _rows(got, "keypoints1_f", "keypoints2_f"), _rows(ref, "keypoints1_f", "keypoints2_f")
    np.testing.assert_array_equal(g[:, :4], r[:, :4])  # integer keypoints: cell corners
    assert np.abs(g[:, 4:] - r[:, 4:]).max() < 1e-3
    assert np.abs(got.keypoints2_f - got.keypoints2).max() <= 8.0 + 1e-3
    assert len(m._fine_cache) == 2


def test_feature_cache_and_threshold(pair):
    a, b = pair
    m = LoftrFeatureMatcher(device="cpu")
    f1, f2 = _F(0, a), _F(1, b)
    res = m.match_frames(f1, f2)
    assert len(m._feat_cache) == 2
    m.match_frames(f1, f2)  # cache hits, no growth
    assert len(m._feat_cache) == 2
    m.drop_frame_cache(f1.matcher_key)
    assert len(m._feat_cache) == 1
    m.drop_frame_cache()
    assert not m._feat_cache
    m.set_threshold(0.5)
    assert m.match_frames(f1, f2).num_matches <= res.num_matches


def test_match_against_many_equals_serial(pair):
    a, b = pair
    frames = [_F(0, a), _F(1, b), _F(2, a)]
    m = LoftrFeatureMatcher(threshold=0.15, device="cpu")
    query = _F(9, b)
    batched = m.match_against_many(query, frames)
    assert len(batched) == 3 and m.match_against_many(query, []) == []
    for fr, res in zip(frames, batched):
        serial = m.match_frames(query, fr)
        assert res.frame2 is fr
        np.testing.assert_array_equal(_rows(res, "octaves2"), _rows(serial, "octaves2"))


@pytest.mark.parametrize("hw", [(240, 320), (600, 800)])
def test_resize_equals_jax(hw):
    img = np.random.default_rng(hw[0]).uniform(0, 255, hw).astype(np.float32)
    img[:, :7] = 255.0  # a bright border band: the edge weights matter
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (480, 640), "bilinear"))
    got = plm.to_model(torch.from_numpy(img))[0, 0].numpy() * 255.0
    assert got.shape == (480, 640)
    assert np.abs(got - ref).max() < 1e-3


def test_matcher_defaults_to_the_card():
    assert inspect.signature(LoftrFeatureMatcher.__init__).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        LoftrFeatureMatcher()
