"""Port parity: estimation/initializer.py against the JAX package's
Initializer, on tests/test_initializer.py's scenes.

The two packages draw their RANSAC minimal sets from different random
streams (`torch.Generator` vs `jax.random`), so the results are held on
what the draw does not decide: the selected model (H or F), success, and the
recovered motion. Both refit on all RANSAC inliers. On the noise-free scenes
R and the direction of t agree within 1e-3 with JAX's and with the ground
truth. Under 0.3 px noise the two draws can end on different inlier sets for
the refit: R still agrees with JAX's within 1e-3, the direction of t within
1e-2 (1e-2 for both with 25 % outliers), and both stay within
test_initializer.py's own ground-truth bounds (R 2e-2..3e-2, t 4e-2..5e-2).
The triangulated sets agree on >= 95 % of the points.
"""

import jax
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch to one thread)
from test_initializer import K, general_scene, planar_scene
from mono_slam_framework_tpu.estimation import Initializer as JaxInitializer
from mono_slam_framework_torch.estimation import Initializer


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _both(uv1, uv2, **kw):
    port = Initializer(K, device="cpu", **kw).initialize(uv1, uv2, _gen())
    ref = JaxInitializer(K, **kw).initialize(uv1, uv2, jax.random.PRNGKey(0))
    return port, ref


def _t_dir(t):
    return t / np.linalg.norm(t)


def _agree(port, ref, tol=1e-3, t_tol=None):
    assert port.success and ref.success
    assert port.used_homography == ref.used_homography
    assert np.abs(port.R21 - ref.R21).max() < tol
    assert np.abs(_t_dir(port.t21) - _t_dir(ref.t21)).max() < (t_tol or tol)
    both = port.triangulated & ref.triangulated
    assert both.sum() >= 0.95 * max(port.triangulated.sum(), ref.triangulated.sum())


@pytest.mark.parametrize("noise,r_tol,t_tol", [(0.0, 1e-3, 1e-3), (0.3, 2e-2, 4e-2)])
def test_general_scene_selects_fundamental(noise, r_tol, t_tol):
    X, R, t, uv1, uv2 = general_scene(np.random.default_rng(0), noise=noise)
    port, ref = _both(uv1, uv2)
    _agree(port, ref, t_tol=1e-3 if noise == 0 else 1e-2)
    assert not port.used_homography
    assert np.abs(port.R21 - R).max() < r_tol
    assert np.abs(_t_dir(port.t21) - _t_dir(t)).max() < t_tol
    assert port.triangulated.sum() > 100
    if noise == 0:
        good = port.triangulated
        np.testing.assert_allclose(port.points3d[good], ref.points3d[good], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("noise,r_tol,t_tol", [(0.0, 1e-3, 1e-3), (0.3, 3e-2, 5e-2)])
def test_planar_scene_selects_homography(noise, r_tol, t_tol):
    X, R, t, uv1, uv2 = planar_scene(np.random.default_rng(0), noise=noise)
    port, ref = _both(uv1, uv2)
    _agree(port, ref, t_tol=1e-3 if noise == 0 else 1e-2)
    assert port.used_homography
    assert np.abs(port.R21 - R).max() < r_tol
    assert np.abs(_t_dir(port.t21) - _t_dir(t)).max() < t_tol


def test_outliers():
    X, R, t, uv1, uv2 = general_scene(np.random.default_rng(0), n=200, outliers=50)
    port, ref = _both(uv1, uv2)
    _agree(port, ref, tol=1e-2)
    assert np.abs(port.R21 - R).max() < 3e-2
    # the outliers are never triangulated
    assert port.triangulated.sum() <= 150 + 5


def test_pure_rotation_fails_in_both():
    rng = np.random.default_rng(0)
    X, _, _, uv1, _ = general_scene(rng, noise=0.0)
    a = 0.05
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]], np.float32)
    Xc2 = X @ R.T
    uv2 = ((Xc2[:, :2] / Xc2[:, 2:]) * 500 + [320, 240]).astype(np.float32)
    port, ref = _both(uv1, uv2, model_fallback=True)
    assert not port.success and not ref.success


def test_deterministic_for_one_generator_seed():
    X, R, t, uv1, uv2 = general_scene(np.random.default_rng(0))
    init = Initializer(K, device="cpu")
    r1 = init.initialize(uv1, uv2, _gen(5))
    r2 = init.initialize(uv1, uv2, _gen(5))
    np.testing.assert_array_equal(r1.R21, r2.R21)
    np.testing.assert_array_equal(r1.points3d, r2.points3d)
    np.testing.assert_array_equal(r1.triangulated, r2.triangulated)


def test_padding_mask_and_direct_oracle():
    """Invalid rows are never triangulated; the no-RANSAC oracle agrees
    with the RANSAC path and with JAX's oracle."""
    X, R, t, uv1, uv2 = general_scene(np.random.default_rng(0), noise=0.2)
    pad = np.zeros((50, 2), np.float32)
    valid = np.concatenate([np.ones(len(uv1), bool), np.zeros(50, bool)])
    init = Initializer(K, device="cpu")
    res = init.initialize(np.concatenate([uv1, pad]), np.concatenate([uv2, pad]),
                          _gen(), valid=valid)
    assert res.success and not res.triangulated[len(uv1):].any()
    direct = init.initialize_direct(uv1, uv2)
    direct_j = JaxInitializer(K).initialize_direct(uv1, uv2)
    assert direct.success and direct_j.success
    np.testing.assert_allclose(direct.R21, res.R21, atol=5e-3)
    np.testing.assert_allclose(direct.R21, direct_j.R21, atol=1e-3)
    np.testing.assert_allclose(_t_dir(direct.t21), _t_dir(direct_j.t21), atol=1e-3)
