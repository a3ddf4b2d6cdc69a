"""Port parity: the public functions the port added last, each against its
JAX function on the same seeded numpy inputs.

se3.exp_so3 / quaternion_to_rotation / make_T, fast.fast_score_map /
detect, filters.box_blur / resize_bilinear, KeyPointMap.is_outlier,
Map.good_bad_map_points, KeyFrame.is_in_image, profiling.trace and the lazy
LoftrFeatureMatcher attribute of the matchers package.
"""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch to one thread)
from torch_parity import t32
from mono_slam_framework_tpu.geometry import se3 as jse3
from mono_slam_framework_tpu.ops import fast as jfast
from mono_slam_framework_tpu.ops import filters as jfilters
from mono_slam_framework_tpu.slam import frame as jframe
from mono_slam_framework_tpu.slam import map_model as jmap
from mono_slam_framework_torch.geometry import se3
from mono_slam_framework_torch.ops import fast, filters
from mono_slam_framework_torch.slam import frame as tframe
from mono_slam_framework_torch.slam import map_model as tmap

RNG = np.random.default_rng(11)


def _image(h=64, w=80, seed=3):
    """A textured grayscale image with real FAST corners: blocks plus noise."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 255, size=(h // 8, w // 8)).repeat(8, 0).repeat(8, 1)
    return (blocks + rng.normal(0, 4, size=(h, w))).clip(0, 255).astype(np.float32)


def test_exp_so3_matches_jax():
    w = RNG.normal(size=(16, 3)) * np.array([[1e-4], [0.03], [0.5], [2.0]] * 4)
    got = se3.exp_so3(t32(w)).numpy()
    want = np.asarray(jse3.exp_so3(jnp.asarray(w, jnp.float32)))
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_quaternion_to_rotation_and_make_T_match_jax():
    q = RNG.normal(size=(10, 4))
    R = se3.quaternion_to_rotation(t32(q)).numpy()
    np.testing.assert_allclose(
        R, np.asarray(jse3.quaternion_to_rotation(jnp.asarray(q, jnp.float32))), atol=1e-6)
    t = RNG.normal(size=(10, 3))
    got = se3.make_T(t32(R), t32(t)).numpy()
    want = np.asarray(jse3.make_T(jnp.asarray(R), jnp.asarray(t, jnp.float32)))
    np.testing.assert_array_equal(got, want)


def test_fast_score_map_matches_jax():
    img = _image()
    mask, score = fast.fast_score_map(t32(img), 20.0)
    jmask, jscore = jfast.fast_score_map(jnp.asarray(img), 20.0)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.sum() > 20
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), atol=1e-4)


def test_detect_matches_jax():
    img = _image(96, 128)
    xs, ys, vals, valid = (t.numpy() for t in fast.detect(t32(img), 64, 20.0, border=8))
    jxs, jys, jvals, jvalid = (np.asarray(a) for a in jfast.detect(jnp.asarray(img), 64, 20.0, border=8))
    np.testing.assert_array_equal(valid, jvalid)
    assert valid.sum() > 10
    # the same corners with the same responses (ties may order differently)
    np.testing.assert_allclose(np.sort(vals[valid]), np.sort(jvals[jvalid]), rtol=1e-4)
    assert set(zip(xs[valid], ys[valid])) == set(zip(jxs[jvalid], jys[jvalid]))


def test_box_blur_matches_jax():
    img = _image()
    for size in (3, 5):
        np.testing.assert_allclose(
            filters.box_blur(t32(img), size).numpy(),
            np.asarray(jfilters.box_blur(jnp.asarray(img), size)), atol=1e-3)


@pytest.mark.parametrize("new_hw", [(32, 40), (100, 150), (64, 80)])
def test_resize_bilinear_matches_jax(new_hw):
    img = _image()
    got = filters.resize_bilinear(t32(img), new_hw).numpy()
    want = np.asarray(jfilters.resize_bilinear(jnp.asarray(img), new_hw))
    assert got.shape == want.shape == new_hw
    np.testing.assert_allclose(got, want, atol=1e-3)


def _twin_maps():
    """The same small map in both packages: a keyframe, 5 points (two bad),
    an outlier association."""
    out = []
    for fr, mm in ((jframe, jmap), (tframe, tmap)):
        mm.reset_map_ids()
        fr.reset_frame_ids()
        m = mm.Map(use_native_graph=False)
        K = np.array([[100, 0, 40], [0, 100, 30], [0, 0, 1]], np.float32)
        frame = fr.Frame(np.zeros((60, 80), np.float32), 0.0, K)
        frame.set_pose(np.eye(4, dtype=np.float32))
        kf = mm.KeyFrame(frame, m, None)
        m.add_keyframe(kf)
        for i in range(5):
            mp = mm.MapPoint(np.array([i, 0.0, 4.0], np.float32), kf, m)
            m.add_map_point(mp)
            kf.keypoint_map.set_map_point((10 + i, 20), mp)
            if i in (1, 3):
                mp.is_bad = True
        kf.keypoint_map.set_outlier(kf.keypoint_map.index_of((12, 20)), True)
        out.append((m, kf))
    return out


def test_map_helpers_match_jax():
    (jm, jkf), (tm, tkf) = _twin_maps()
    assert tm.good_bad_map_points() == jm.good_bad_map_points() == (3, 2)
    for x, y in ((0, 0), (79.9, 59.9), (80, 10), (-0.1, 5), (40, 60)):
        assert tkf.is_in_image(x, y) == jkf.is_in_image(x, y)
    for kp in ((10, 20), (12, 20), (30, 30)):
        i = tkf.keypoint_map.index_of(kp)
        assert tkf.keypoint_map.is_outlier(i) == jkf.keypoint_map.is_outlier(i)
    assert tkf.keypoint_map.is_outlier(tkf.keypoint_map.index_of((12, 20)))


def test_profiling_trace_writes_a_trace(tmp_path):
    from mono_slam_framework_torch.utils import profiling

    with profiling.trace(str(tmp_path)):
        torch.ones(64).cumsum(0)
    assert any(p.suffix == ".json" for p in tmp_path.rglob("*"))


def test_loftr_matcher_is_a_lazy_attribute():
    """Importing the matchers package leaves the LoFTR module unloaded until
    the attribute is read (a fresh interpreter: this one has loaded it)."""
    code = (
        "import sys\n"
        "import mono_slam_framework_torch.matchers as m\n"
        "lm = 'mono_slam_framework_torch.matchers.loftr_matcher'\n"
        "assert lm not in sys.modules\n"
        "assert m.LoftrFeatureMatcher.__name__ == 'LoftrFeatureMatcher'\n"
        "assert lm in sys.modules\n"
        "try:\n"
        "    m.NoSuchMatcher\n"
        "except AttributeError:\n"
        "    print('ok')\n"
    )
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
