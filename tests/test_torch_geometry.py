"""Port parity: geometry/projection.py, geometry/triangulation.py and
geometry/epipolar.py against the JAX package, on tests/test_geometry.py's
scenes, in f32 and in f64 (JAX under `jax.enable_x64`).

Tolerances: f32 rtol 1e-4 (pixels, rays, cosines; 1e-3 where an SVD null
vector feeds a division), f64 rtol 1e-9. Quantities an SVD fixes only up to
sign (F, H, t, the order of the Faugeras hypotheses) are compared up to that
sign or as sets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import t32
from test_geometry import synthetic_two_view
from mono_slam_framework_tpu.geometry import epipolar as jepi
from mono_slam_framework_tpu.geometry import projection as jproj
from mono_slam_framework_tpu.geometry import triangulation as jtri
from mono_slam_framework_torch.geometry import epipolar, projection, triangulation

DTYPES = {"f32": (np.float32, 1e-4, 1e-3), "f64": (np.float64, 1e-9, 1e-9)}


@pytest.fixture(params=sorted(DTYPES))
def prec(request):
    """(numpy dtype, rtol, rtol after an SVD) under the matching JAX mode."""
    dt, rtol, rtol_svd = DTYPES[request.param]
    with jax.enable_x64(dt == np.float64):
        yield dt, rtol, rtol_svd


def _j(x, dt):
    return jnp.asarray(np.asarray(x, dt))


def _t(x, dt):
    return t32(x, dt)


def _scene(dt):
    K, X, R2, t2, uv1, uv2 = synthetic_two_view(np.random.default_rng(0), noise=0.3)
    return tuple(np.asarray(a, dt) for a in (K, X, R2, t2, uv1, uv2))


def _planar(dt):
    """tests/test_geometry.py's planar scene (60 points on z = 5)."""
    rng = np.random.default_rng(0)
    n = 60
    Xp = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), np.full(n, 5.0)], -1)
    a = 0.15
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([-0.6, 0.1, 0.05])
    uv1 = (Xp[:, :2] / Xp[:, 2:3]) * 500 + [320, 240]
    Xc2 = Xp @ R.T + t
    uv2 = (Xc2[:, :2] / Xc2[:, 2:3]) * 500 + [320, 240]
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    return tuple(np.asarray(v, dt) for v in (K, R, t, uv1, uv2))


def _close(got, ref, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


def _up_to_sign(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


def test_projection(prec):
    dt, rtol, _ = prec
    K, X, R2, t2, uv1, _ = _scene(dt)
    T = np.eye(4, dtype=dt)
    T[:3, :3], T[:3, 3] = R2, t2
    _close(projection.project(_t(X, dt), _t(K, dt)), jproj.project(_j(X, dt), _j(K, dt)), rtol)
    _close(projection.backproject(_t(uv1, dt), _t(K, dt)),
           jproj.backproject(_j(uv1, dt), _j(K, dt)), rtol, 1e-6)
    _close(projection.transform_points(_t(T, dt), _t(X, dt)),
           jproj.transform_points(_j(T, dt), _j(X, dt)), rtol, 1e-6)


def test_in_frustum(prec):
    dt, _, _ = prec
    K, X, R2, t2, _, _ = _scene(dt)
    T = np.eye(4, dtype=dt)
    T[:3, :3], T[:3, 3] = R2, t2
    normals = (X / np.linalg.norm(X, axis=-1, keepdims=True)).astype(dt)
    # half the points beyond their distance bound, some behind the camera
    max_dist = np.where(np.arange(len(X)) % 2 == 0, 100.0, 7.0).astype(dt)
    Xm = X.copy()
    Xm[::7] *= -1
    args = (T, K, Xm, normals, max_dist)
    got = projection.in_frustum(*(_t(a, dt) for a in args), 640.0, 480.0, 0.5).numpy()
    ref = np.asarray(jproj.in_frustum(*(_j(a, dt) for a in args), 640.0, 480.0, 0.5))
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < len(X)


def test_triangulate_dlt_and_parallax(prec):
    dt, _, rtol_svd = prec
    K, X, R2, t2, uv1, uv2 = _scene(dt)
    P1 = (K @ np.hstack([np.eye(3), np.zeros((3, 1))])).astype(dt)
    P2 = (K @ np.hstack([R2, t2[:, None]])).astype(dt)
    Xp, w = triangulation.triangulate_dlt(*(_t(a, dt) for a in (uv1, uv2, P1, P2)))
    Xj, wj = jtri.triangulate_dlt(*(_j(a, dt) for a in (uv1, uv2, P1, P2)))
    _close(Xp, Xj, rtol_svd)
    assert (w.numpy() != 0).all()
    cos = triangulation.rays_cos_parallax(
        *(_t(a, dt) for a in (uv1, uv2, K, K, np.eye(3), R2.T)))
    cos_j = jtri.rays_cos_parallax(*(_j(a, dt) for a in (uv1, uv2, K, K, np.eye(3), R2.T)))
    _close(cos, cos_j, 1e-6)


def test_triangulate_gated_single_and_many(prec):
    """One pair through triangulate_gated, and three pairs (other second
    poses, a padded tail) through triangulate_gated_many, against JAX's
    jitted single and vmapped forms."""
    dt, _, rtol_svd = prec
    K, X, R2, t2, uv1, uv2 = _scene(dt)
    T1 = np.eye(4, dtype=dt)
    rng = np.random.default_rng(1)
    B, n = 3, len(X)
    T2s = np.tile(np.eye(4, dtype=dt), (B, 1, 1))
    uv2s = np.zeros((B, n, 2), dt)
    for b in range(B):
        T2s[b, :3, :3] = R2
        T2s[b, :3, 3] = t2 * (1.0 + 0.5 * b)
        Xc = X @ R2.T + T2s[b, :3, 3]
        uv2s[b] = (Xc[:, :2] / Xc[:, 2:3]) * 500 + [320, 240] + rng.normal(0, 0.5, (n, 2))
    uv1s = np.broadcast_to(uv1, (B, n, 2)).copy()
    valid = np.ones((B, n), bool)
    valid[2, n // 2:] = False
    Ks = np.broadcast_to(K, (B, 3, 3)).copy()
    X1, ok1 = triangulation.triangulate_gated(
        *(_t(a, dt) for a in (uv1, uv2, )), torch.from_numpy(valid[0]),
        *(_t(a, dt) for a in (K, K, T1, T2s[0])), 1.1)
    X1j, ok1j = jtri.triangulate_gated(
        _j(uv1, dt), _j(uv2, dt), jnp.asarray(valid[0]),
        *(_j(a, dt) for a in (K, K, T1, T2s[0])), 1.1)
    np.testing.assert_array_equal(ok1.numpy(), np.asarray(ok1j))
    _close(X1.numpy()[ok1.numpy()], np.asarray(X1j)[np.asarray(ok1j)], rtol_svd)
    Xb, okb = triangulation.triangulate_gated_many(
        _t(uv1s, dt), _t(uv2s, dt), torch.from_numpy(valid),
        *(_t(a, dt) for a in (K, Ks, T1, T2s)), 1.1)
    Xbj, okbj = jtri.triangulate_gated_many(
        _j(uv1s, dt), _j(uv2s, dt), jnp.asarray(valid),
        *(_j(a, dt) for a in (K, Ks, T1, T2s)), 1.1)
    okb, okbj = okb.numpy(), np.asarray(okbj)
    # a point on a chi2 or parallax gate may fall either side in f32
    assert (okb == okbj).mean() >= (0.99 if dt == np.float32 else 1.0)
    both = okb & okbj
    _close(Xb.numpy()[both], np.asarray(Xbj)[both], rtol_svd)
    assert okb[:2].sum() > 80 and not okb[2, n // 2:].any()


def test_normalize_and_eight_point(prec):
    dt, rtol, rtol_svd = prec
    K, X, R2, t2, uv1, uv2 = _scene(dt)
    valid = np.ones(len(uv1), bool)
    valid[-5:] = False
    n1, T1 = epipolar.normalize_points(_t(uv1, dt), torch.from_numpy(valid))
    n1j, T1j = jepi.normalize_points(_j(uv1, dt), jnp.asarray(valid))
    _close(n1, n1j, rtol, 1e-6)
    _close(T1, T1j, rtol, 1e-6)
    n2, _ = epipolar.normalize_points(_t(uv2, dt), torch.from_numpy(valid))
    n2j, _ = jepi.normalize_points(_j(uv2, dt), jnp.asarray(valid))
    F = epipolar.compute_fundamental(n1[:8], n2[:8])
    Fj = jepi.compute_fundamental(n1j[:8], n2j[:8])
    assert _up_to_sign(F.numpy(), Fj) < rtol_svd * 10
    w = torch.from_numpy(valid.astype(dt))
    Fw = epipolar.compute_fundamental(n1, n2, w)
    Fwj = jepi.compute_fundamental(n1j, n2j, jnp.asarray(valid.astype(dt)))
    assert _up_to_sign(Fw.numpy(), Fwj) < rtol_svd * 10
    # batched minimal sets equal the per-set calls
    sets = np.stack([np.arange(8), np.arange(8, 16), np.arange(20, 28)])
    Fb = epipolar.compute_fundamental(n1[sets], n2[sets])
    for b in range(3):
        assert _up_to_sign(Fb[b].numpy(), jepi.compute_fundamental(n1j[sets[b]], n2j[sets[b]])) \
            < rtol_svd * 10


def test_scores(prec):
    dt, rtol, _ = prec
    K, X, R2, t2, uv1, uv2 = _scene(dt)
    _, R, t, p1, p2 = _planar(dt)
    valid = np.ones(len(uv1), bool)
    # F from the true motion: E = [t]x R, F = K^-T E K^-1
    tx = np.array([[0, -t2[2], t2[1]], [t2[2], 0, -t2[0]], [-t2[1], t2[0], 0]])
    Kinv = np.linalg.inv(K.astype(np.float64))
    Fm = (Kinv.T @ tx @ R2 @ Kinv).astype(dt)
    s, inl = epipolar.score_fundamental(_t(Fm, dt), _t(uv1, dt), _t(uv2, dt),
                                        torch.from_numpy(valid), 1.0)
    sj, inlj = jepi.score_fundamental(_j(Fm, dt), _j(uv1, dt), _j(uv2, dt),
                                      jnp.asarray(valid), 1.0)
    _close(s, sj, rtol)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inlj))
    # the homography of the planar scene's motion
    nrm = np.array([0.0, 0.0, 1.0])
    Hm = (K @ (R + np.outer(t, nrm) / 5.0) @ np.linalg.inv(K)).astype(dt)
    validp = np.ones(len(p1), bool)
    s, inl = epipolar.score_homography(
        _t(Hm, dt), _t(np.linalg.inv(Hm), dt), _t(p1, dt), _t(p2, dt),
        torch.from_numpy(validp), 1.0)
    sj, inlj = jepi.score_homography(
        _j(Hm, dt), _j(np.linalg.inv(Hm), dt), _j(p1, dt), _j(p2, dt),
        jnp.asarray(validp), 1.0)
    _close(s, sj, rtol)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inlj))
    assert inl.numpy().mean() > 0.9


def test_decompositions(prec):
    dt, _, rtol_svd = prec
    K, X, R2, t2, uv1, uv2 = _scene(dt)
    tx = np.array([[0, -t2[2], t2[1]], [t2[2], 0, -t2[0]], [-t2[1], t2[0], 0]])
    E = (tx @ R2).astype(dt)
    R1p, R2p, tp = epipolar.decompose_essential(_t(E, dt))
    R1j, R2j, tj = jepi.decompose_essential(_j(E, dt))
    got = sorted(np.asarray(r).ravel().tolist() for r in (R1p.numpy(), R2p.numpy()))
    ref = sorted(np.asarray(r).ravel().tolist() for r in (R1j, R2j))
    _close(got, ref, 0, rtol_svd)
    assert _up_to_sign(tp.numpy(), tj) < rtol_svd

    K, R, t, p1, p2 = _planar(dt)
    Hm = (K @ (R + np.outer(t, [0.0, 0.0, 1.0]) / 5.0) @ np.linalg.inv(K)).astype(dt)
    Rs, ts, ok = epipolar.decompose_homography_faugeras(_t(Hm, dt), _t(K, dt))
    Rsj, tsj, okj = jepi.decompose_homography_faugeras(_j(Hm, dt), _j(K, dt))
    assert bool(ok) and bool(okj)
    # the same 8 motions, in whatever order the SVD signs give
    ours = np.concatenate([Rs.numpy().reshape(8, 9), ts.numpy()], 1)
    theirs = np.concatenate([np.asarray(Rsj).reshape(8, 9), np.asarray(tsj)], 1)
    d = np.abs(ours[:, None] - theirs[None]).max(-1)
    assert d.min(1).max() < 100 * rtol_svd and d.min(0).max() < 100 * rtol_svd
