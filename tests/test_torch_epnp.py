"""Port parity for EPnP + RANSAC (estimation/epnp.py).

  * the solver on a shared basis: for a minimal set of 4, M^T M has a
    4-dimensional null space whose basis each eigensolver picks its own way,
    and the beta cases seeded from that basis reach other poses (measured
    here in f32 with each package's own basis: 14-20 of 64 sets agree to
    1e-4; on one shared basis in f32, up to 0.23 apart, the 6-step
    Gauss-Newton in f32 being that sensitive). So the port's `_epnp_solve`
    is held to the JAX `_epnp_pose` on the JAX package's own basis in f64:
    R and t within 1e-9 and 1e-8 (measured 6e-11 and 1e-9);
  * the weighted solve over 60 points, 50 of them weighted 1 (the refine
    form, a well-posed basis) in f32, the package's precision: R within
    1e-4, t within 1e-3 (measured 2.3e-6 and 1.6e-5 on seeds 1-5; on seed
    0 the two packages keep different beta cases of near-equal error, 8e-4
    apart, the port's the closer to the truth);
  * `_count_inliers` on the same poses: masks and counts equal;
  * over the same 64 noise-free minimal sets, the hypothesis with the most
    inliers is the true pose in both packages;
  * test_epnp.py's five cases through the port's `solve_pnp_ransac` with a
    seeded host generator, agreeing with the JAX result's `ok` and bounds;
  * the adaptive hypothesis count against epnp.py:265-290 over a grid of N.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch to one thread)
from mono_slam_framework_tpu.estimation import epnp as je
from mono_slam_framework_torch.estimation import epnp as pe
from test_epnp import K, make_problem

N_SETS = 64
TH2 = 5.991


def _minimal_sets(rng, n, count=N_SETS):
    return np.stack([rng.choice(n, 4, replace=False) for _ in range(count)])


@jax.jit
def _jax_hypotheses(X, uv, sets, valid):
    """The JAX package's per-hypothesis poses and inliers (the body of its
    `_ransac_epnp`, on given sets)."""
    R, t, _ = jax.vmap(lambda i: je._epnp_pose(X[i], uv[i], jnp.asarray(K), jnp.ones(4)))(sets)
    inl, cnt = jax.vmap(lambda r, tt: je._count_inliers(
        r, tt, X, uv, jnp.asarray(K), valid, jnp.float32(TH2)))(R, t)
    return R, t, inl, cnt


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _jax_basis(X, uv, K_, w):
    """The JAX `_epnp_pose`'s own first steps: control points, alphas and
    the four smallest eigenvectors of M^T M."""
    Cw = je._control_points(X, w)
    alphas = je._barycentric(X, Cw)
    M = je._build_M(alphas, uv, K_, w)
    _, evec = jnp.linalg.eigh(M.T @ M)
    return Cw, alphas, evec[:, :4].T


@pytest.mark.parametrize("noise", [0.0, 0.5])
def test_epnp_solve_matches_jax_on_a_shared_basis(noise):
    rng = np.random.default_rng(1)
    _, X, uv, _ = make_problem(rng, n=60, noise=noise)
    sets = _minimal_sets(rng, 60)
    X, uv, K64 = X.astype(np.float64), uv.astype(np.float64), K.astype(np.float64)
    with jax.enable_x64(True):
        Xs, uvs = jnp.asarray(X)[sets], jnp.asarray(uv)[sets]
        w = jnp.ones(4, jnp.float64)

        def both(x, u):
            # one program: the pose and the basis it was built on
            return je._epnp_pose(x, u, jnp.asarray(K64), w), _jax_basis(x, u, jnp.asarray(K64), w)

        (R_j, t_j, e_j), basis = jax.jit(jax.vmap(both))(Xs, uvs)
        R_j, t_j, e_j = map(np.asarray, (R_j, t_j, e_j))
        basis = [np.asarray(a) for a in basis]
    assert R_j.dtype == np.float64
    R_p, t_p, e_p = pe._epnp_solve(_t(X)[sets], _t(uv)[sets], _t(K64),
                                   torch.ones(N_SETS, 4, dtype=torch.float64),
                                   *(_t(a) for a in basis))
    np.testing.assert_allclose(R_p.numpy(), R_j, atol=1e-9)
    np.testing.assert_allclose(t_p.numpy(), t_j, atol=1e-8)
    np.testing.assert_allclose(e_p.numpy(), e_j, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_weighted_epnp_matches_jax(seed):
    rng = np.random.default_rng(seed)
    _, X, uv, out_idx = make_problem(rng, n=60, noise=0.5, n_outliers=10)
    w = np.ones(60, np.float32)
    w[out_idx] = 0.0  # the refine form: the inlier mask as weights
    R_j, t_j, e_j = map(np.asarray, jax.jit(je._epnp_pose)(
        jnp.asarray(X), jnp.asarray(uv), jnp.asarray(K), jnp.asarray(w)))
    R_p, t_p, e_p = pe._epnp_pose(_t(X)[None], _t(uv)[None], _t(K), _t(w)[None])
    np.testing.assert_allclose(R_p[0].numpy(), R_j, atol=1e-4)
    np.testing.assert_allclose(t_p[0].numpy(), t_j, atol=1e-3)
    np.testing.assert_allclose(e_p[0].numpy(), e_j, rtol=1e-3, atol=1e-3)


def test_count_inliers_equal_on_the_same_poses():
    rng = np.random.default_rng(4)
    _, X, uv, _ = make_problem(rng, n=60, noise=0.5, n_outliers=15)
    sets = _minimal_sets(rng, 60)
    valid = np.ones(60, bool)
    valid[-5:] = False
    R, t, inl_j, cnt_j = _jax_hypotheses(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(sets),
                                         jnp.asarray(valid))
    inl_p, cnt_p = pe._count_inliers(_t(R), _t(t), _t(X), _t(uv), _t(K), _t(valid), TH2)
    np.testing.assert_array_equal(inl_p.numpy(), np.asarray(inl_j))
    np.testing.assert_array_equal(cnt_p.numpy(), np.asarray(cnt_j))
    assert 0 < cnt_p.max() <= 55


def test_best_minimal_hypothesis_is_the_true_pose_in_both():
    rng = np.random.default_rng(5)
    T, X, uv, _ = make_problem(rng, n=60, noise=0.0)
    sets = _minimal_sets(rng, 60)
    valid = np.ones(60, bool)
    R, t, _, cnt = _jax_hypotheses(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(sets),
                                   jnp.asarray(valid))
    b = int(jnp.argmax(cnt))
    R_p, t_p, _, cnt_p = pe._ransac_epnp(_t(X), _t(uv), _t(valid), _t(K), _t(sets), TH2)
    assert int(cnt[b]) == int(cnt_p) == 60
    for R_, t_ in ((np.asarray(R[b]), np.asarray(t[b])), (R_p.numpy(), t_p.numpy())):
        assert np.abs(R_ - T[:3, :3]).max() < 1e-3
        assert np.abs(t_ - T[:3, 3]).max() < 1e-2


def _case(name, rng):
    """test_epnp.py's problems: (X, uv, expected ok, pose bound, outliers)."""
    if name == "recovers_pose":
        T, X, uv, out = make_problem(rng)
        return T, X, uv, 5e-2, out
    if name == "outlier_rejection":
        T, X, uv, out = make_problem(rng, n=80, n_outliers=20)
        return T, X, uv, 8e-2, out
    if name == "too_few_points":
        T, X, uv, out = make_problem(rng, n=3)
        return T, X, uv, None, out
    X = rng.uniform(-2, 2, (40, 3)).astype(np.float32)
    uv = rng.uniform(0, 640, (40, 2)).astype(np.float32)
    return None, X, uv, None, np.array([], int)


@pytest.mark.parametrize("name", ["recovers_pose", "outlier_rejection", "too_few_points",
                                  "garbage_rejected", "deterministic"])
def test_solve_pnp_ransac_cases(name):
    rng = np.random.default_rng(0)  # the rng fixture of tests/conftest.py
    T, X, uv, bound, out_idx = _case("recovers_pose" if name == "deterministic" else name, rng)
    ok_j, T_j, inl_j = je.solve_pnp_ransac(X, uv, K, jax.random.PRNGKey(0))
    gen = torch.Generator()
    gen.manual_seed(0)
    ok_p, T_p, inl_p = pe.solve_pnp_ransac(X, uv, K, gen, device="cpu")
    assert ok_p == ok_j
    assert inl_p.shape == (len(X),) and inl_p.dtype == bool
    if name == "deterministic":
        gen.manual_seed(0)
        ok2, T2, inl2 = pe.solve_pnp_ransac(X, uv, K, gen, device="cpu")
        assert ok2 == ok_p
        np.testing.assert_array_equal(T2, T_p)
        np.testing.assert_array_equal(inl2, inl_p)
    if bound is None:
        assert not ok_p
        return
    assert ok_p
    for T_, inl in ((T_j, inl_j), (T_p, inl_p)):
        assert np.abs(T_ - T).max() < bound
        assert inl.sum() >= 50
        assert not inl[out_idx].any()
    # both refine on their own inliers of the same problem: close poses
    assert np.abs(T_p - T_j).max() < bound


def test_hypothesis_count_matches_jax():
    """The port's ransac_iterations against the `iterations` the JAX
    `solve_pnp_ransac` hands its RANSAC program (epnp.py:265-290), N from 3
    to 400 under three parameter sets; N where the JAX function returns
    early gives None."""
    seen = []

    def spy(X, uv, valid, K_, key, th2, iterations, min_set):
        seen.append(iterations)
        return jnp.eye(3), jnp.zeros(3), jnp.zeros(X.shape[0], bool), jnp.int32(0)

    rng = np.random.default_rng(0)
    grid = [3, 4, 5, 7, 8, 10, 12, 16, 19, 20, 21, 25, 30, 40, 63, 64, 100, 139, 250, 400]
    params = [dict(), dict(max_iterations=100, probability=0.9),
              dict(min_inliers=30, epsilon=0.7)]
    with mock.patch.object(je, "_ransac_epnp", spy):
        for kw in params:
            for n in grid:
                seen.clear()
                X = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
                uv = rng.uniform(0, 320, (n, 2)).astype(np.float32)
                ok, _, _ = je.solve_pnp_ransac(X, uv, K, jax.random.PRNGKey(0), **kw)
                assert not ok
                _, hyp = pe.ransac_iterations(n, **kw)
                assert hyp == (seen[0] if seen else None), (n, kw, seen, hyp)
    assert pe.ransac_iterations(139)[1] == 64 and pe.ransac_iterations(10)[1] == 1


def test_minimal_set_draws():
    gen = torch.Generator()
    gen.manual_seed(3)
    sets = pe.draw_minimal_sets(30, 256, 4, gen)
    assert sets.shape == (256, 4) and sets.dtype == torch.int64
    assert int(sets.min()) >= 0 and int(sets.max()) < 30
    assert all(len(set(row)) == 4 for row in sets.tolist())
    gen.manual_seed(3)
    assert torch.equal(pe.draw_minimal_sets(30, 256, 4, gen), sets)
    assert len({tuple(sorted(r)) for r in sets.tolist()}) > 200  # not one set repeated
