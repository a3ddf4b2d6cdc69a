"""Port parity: geometry/se3 against the JAX package, in f32 and f64.

The same numpy tangents and rotations go through both. The tangents cover
the widened Taylor region (theta < 0.05), both sides of its boundary and
large angles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch to one thread)
from mono_slam_framework_tpu.geometry import se3 as jse3
from mono_slam_framework_torch.geometry import se3

# f32: the closed forms lose ~1e-7 relative near the boundary; f64 agrees to
# round-off
TOL = {np.float32: 2e-6, np.float64: 1e-12}


def _tangents(dtype):
    rng = np.random.default_rng(5)
    dirs = rng.normal(size=(12, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    # theta in the Taylor region, at its edge (0.05) from both sides, large
    thetas = np.array([0.0, 1e-6, 1e-3, 0.02, 0.0499, 0.04999999, 0.05,
                       0.05000001, 0.0501, 0.3, 1.5, 3.0])
    w = dirs * thetas[:, None]
    v = rng.normal(size=(12, 3))
    return np.concatenate([w, v], axis=1).astype(dtype)


@pytest.fixture(params=[np.float32, np.float64], ids=["f32", "f64"])
def dtype(request):
    return request.param


def _jax(fn, x, dtype):
    with jax.enable_x64(dtype == np.float64):
        return np.array(fn(jnp.asarray(x, dtype)))  # a writable copy


def test_exp_se3(dtype):
    xi = _tangents(dtype)
    got = se3.exp_se3(torch.from_numpy(xi)).numpy()
    ref = _jax(jse3.exp_se3, xi, dtype)
    assert got.dtype == dtype
    np.testing.assert_allclose(got, ref, atol=TOL[dtype])


def test_log_se3(dtype):
    xi = _tangents(dtype)[:-1]  # theta = 3.0 is close to pi: log is ill-posed
    T = _jax(jse3.exp_se3, xi, dtype)
    got = se3.log_se3(torch.from_numpy(T)).numpy()
    ref = _jax(jse3.log_se3, T, dtype)
    np.testing.assert_allclose(got, ref, atol=20 * TOL[dtype])
    # and the round trip recovers the tangent
    np.testing.assert_allclose(got, xi, atol=1e-4 if dtype == np.float32 else 1e-9)


def test_orthonormalize(dtype):
    rng = np.random.default_rng(6)
    T = _jax(jse3.exp_se3, _tangents(dtype), dtype)
    T[:, :3, :3] += rng.normal(0, 1e-3, (len(T), 3, 3)).astype(dtype)
    got = se3.orthonormalize(torch.from_numpy(T)).numpy()
    ref = _jax(jse3.orthonormalize, T, dtype)
    np.testing.assert_allclose(got, ref, atol=TOL[dtype])
    R = got[:, :3, :3]
    eye = np.broadcast_to(np.eye(3), R.shape)
    # two Newton steps from ~3e-3 off-manifold leave ~1e-10 (f64) / f32 eps
    ortho_tol = 1e-9 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), eye, atol=ortho_tol)


def test_rotation_to_quaternion(dtype):
    T = _jax(jse3.exp_se3, _tangents(dtype), dtype)
    # a half turn about each axis exercises the x/y/z-major branches
    flips = np.stack([np.diag(d) for d in ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])])
    R = np.concatenate([T[:, :3, :3], flips.astype(dtype)])
    got = se3.rotation_to_quaternion(torch.from_numpy(R)).numpy()
    ref = _jax(jse3.rotation_to_quaternion, R, dtype)
    np.testing.assert_allclose(got, ref, atol=TOL[dtype])
    assert (got[:, 3] >= 0).all()  # [qx, qy, qz, qw] with qw >= 0


def test_inverse_and_camera_center(dtype):
    T = _jax(jse3.exp_se3, _tangents(dtype), dtype)
    Tt = torch.from_numpy(T)
    np.testing.assert_allclose(
        se3.inverse(Tt).numpy(), _jax(jse3.inverse, T, dtype), atol=TOL[dtype]
    )
    np.testing.assert_allclose(
        se3.camera_center(Tt).numpy(), _jax(jse3.camera_center, T, dtype),
        atol=10 * TOL[dtype],
    )
