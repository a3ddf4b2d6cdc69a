"""Port parity for the essential graph (optim/pose_graph.py) and the Sim(3)
utilities it is fed by (geometry/sim3.py, a copy of the JAX package's numpy
module).

  * test_pose_graph.py's three graphs through both packages'
    `optimize_pose_graph_np`: poses within 1e-4 (measured 1.2e-6), the gauge
    node unchanged;
  * a non-finite graph returns None;
  * the Jacobian `torch.func.jacfwd` takes at zero residual (identity poses,
    identity measurements: the derivative through log_so3 at theta = 0 that
    the JAX package's se3.py:88-96 guards) is finite, and equals the
    JAX package's `jax.jacfwd` of its own residuals to 1e-5;
  * the solver's analytic per-edge Jacobian against the JAX package's
    `jax.jacfwd` of its residuals, on random graphs whose edge errors range
    from zero to 2.8 rad: residuals and Jacobian each within 1e-4 x (1 + its
    largest entry), edges within 0.05 rad of pi aside; near pi, on float64
    rotations, against torch.func.jacfwd to 1e-9;
  * se3.compose;
  * the sim3 copy against the JAX module on test_sim3.py's cases, within
    1e-6 (the same numpy code: measured equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch to one thread)
import test_pose_graph as tpg
from mono_slam_framework_tpu.geometry import se3 as jse3
from mono_slam_framework_tpu.geometry import sim3 as jsim3
from mono_slam_framework_tpu.optim import pose_graph as jpg
from mono_slam_framework_torch.geometry import se3, sim3
from mono_slam_framework_torch.optim import pose_graph as ppg


def _graph(name):
    """test_pose_graph.py's graphs: (T_nodes, fixed, e_i, e_j, T_meas, w)."""
    rng = np.random.default_rng({"drift": 0, "rotation": 3}.get(name, 0))
    truth = tpg._square_truth(n_side=3 if name == "consistent" else 6)
    n = len(truth)
    fixed = np.zeros(n, bool)
    fixed[0] = True
    e_i, e_j = list(range(1, n)), list(range(0, n - 1))
    if name == "consistent":
        T_meas = [truth[k] @ np.linalg.inv(truth[k - 1]) for k in range(1, n)]
        return np.stack(truth), fixed, e_i, e_j, np.stack(T_meas), None
    if name == "drift":
        drifted = tpg.TestPoseGraph()._drift(truth, rng)
    else:
        drifted = [truth[0]]
        for k in range(1, n):
            rel = (truth[k] @ np.linalg.inv(truth[k - 1])).copy()
            rel[:3, :3] = jsim3.exp_so3(np.array([0.0, 0.004, 0.0])) @ rel[:3, :3]
            drifted.append((rel @ drifted[-1]).astype(np.float32))
    T_meas = [drifted[k] @ np.linalg.inv(drifted[k - 1]) for k in range(1, n)]
    T_meas.append(truth[n - 1] @ np.linalg.inv(truth[0]))
    w = [1.0] * (n - 1) + [5.0]
    return np.stack(drifted), fixed, e_i + [n - 1], e_j + [0], np.stack(T_meas), w


@pytest.mark.parametrize("name", ["drift", "consistent", "rotation"])
def test_pose_graph_matches_jax(name):
    T0, fixed, e_i, e_j, T_meas, w = _graph(name)
    got = ppg.optimize_pose_graph_np(T0, fixed, e_i, e_j, T_meas, w, device="cpu")
    ref = jpg.optimize_pose_graph_np(T0, fixed, e_i, e_j, T_meas, w)
    assert got.shape == T0.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_array_equal(got[0], T0[0].astype(np.float32))  # the gauge node
    if name != "consistent":
        assert np.abs(got - T0).max() > 1e-2  # the loop edge moved the chain


def test_non_finite_graph_returns_none():
    T0, fixed, e_i, e_j, T_meas, w = _graph("drift")
    T0 = T0.copy()
    T0[3, 0, 3] = np.nan
    assert ppg.optimize_pose_graph_np(T0, fixed, e_i, e_j, T_meas, w, device="cpu") is None


def test_jacobian_is_finite_at_zero_residual():
    n, e_i, e_j = 3, np.array([1, 2, 2]), np.array([0, 1, 0])
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    Tm = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    w = np.array([1.0, 1.0, 4.0], np.float32)

    def res_p(xi):
        Tn = se3.compose(se3.exp_se3(xi.reshape(n, 6)), torch.from_numpy(T))
        return ppg._edge_residuals(Tn, torch.from_numpy(e_i), torch.from_numpy(e_j),
                                   torch.from_numpy(Tm), torch.sqrt(torch.from_numpy(w))).reshape(-1)

    def res_j(xi):
        Tn = jax.vmap(lambda x, t: jse3.compose(jse3.exp_se3(x), t))(xi.reshape(n, 6), jnp.asarray(T))
        return jpg._edge_residuals(Tn, jnp.asarray(e_i), jnp.asarray(e_j), jnp.asarray(Tm),
                                   jnp.sqrt(jnp.asarray(w))).reshape(-1)

    J = torch.func.jacfwd(res_p)(torch.zeros(6 * n))
    assert J.shape == (18, 18) and bool(torch.isfinite(J).all())
    assert float(res_p(torch.zeros(6 * n)).abs().max()) == 0.0
    np.testing.assert_allclose(J.numpy(), np.asarray(jax.jit(jax.jacfwd(res_j))(jnp.zeros(6 * n))),
                               atol=1e-5)


@pytest.mark.parametrize("scale", [0.0, 1e-4, 0.05, 0.5, 1.5, 2.8])
def test_analytic_jacobian_matches_jax(scale):
    rng = np.random.default_rng(int(scale * 1e4) + 1)
    n, e = 5, 9
    T = np.asarray(se3.exp_se3(torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32))))
    e_i = rng.integers(0, n, e)
    e_j = (e_i + 1 + rng.integers(0, n - 1, e)) % n
    noise = se3.exp_se3(torch.from_numpy((rng.normal(size=(e, 6)) * scale).astype(np.float32)))
    Tm = (noise @ torch.from_numpy(T[e_i] @ np.linalg.inv(T[e_j]))).numpy()
    w = rng.uniform(0.5, 3.0, e).astype(np.float32)

    def res_j(xi):
        Tn = jax.vmap(lambda x, t: jse3.compose(jse3.exp_se3(x), t))(xi.reshape(n, 6), jnp.asarray(T))
        Tmi = jax.vmap(jse3.inverse)(jnp.asarray(Tm))
        return jpg._edge_residuals(Tn, jnp.asarray(e_i), jnp.asarray(e_j), Tmi,
                                   jnp.sqrt(jnp.asarray(w))).reshape(-1)

    ref = np.asarray(jax.jit(jax.jacfwd(res_j))(jnp.zeros(6 * n)))
    r, J_i, J_j = ppg._edge_jacobians(torch.from_numpy(T), torch.from_numpy(e_i),
                                      torch.from_numpy(e_j), se3.inverse(torch.from_numpy(Tm)),
                                      torch.sqrt(torch.from_numpy(w)))
    J = np.zeros((e, 6, n, 6), np.float32)
    for k in range(e):
        J[k, :, e_i[k]] += J_i[k].numpy()
        J[k, :, e_j[k]] += J_j[k].numpy()
    r_ref = np.asarray(res_j(jnp.zeros(6 * n))).reshape(e, 6)
    np.testing.assert_allclose(r.numpy(), r_ref, atol=1e-4 * (1 + np.abs(r_ref).max()))
    # within 0.05 rad of pi the log of an f32 rotation is ill-conditioned
    # (1 / sin^2): jacfwd differentiates its formula off the rotations, the
    # analytic form is the derivative on them (test_analytic_jacobian_near_pi)
    ok = np.pi - np.linalg.norm(r_ref[:, :3] / np.sqrt(w)[:, None], axis=1) > 0.05
    assert ok.sum() >= e - 1
    ref = ref.reshape(e, 6, 6 * n)[ok]
    np.testing.assert_allclose(J.reshape(e, 6, 6 * n)[ok], ref, atol=1e-4 * (1 + np.abs(ref).max()))


@pytest.mark.parametrize("theta", [3.0, 3.1, 3.138, 3.14])
def test_analytic_jacobian_near_pi(theta):
    """Near pi, on exact (float64) rotations: the inverse left Jacobian
    against torch.func.jacfwd of log(exp(d) D) to 1e-9."""
    rng = np.random.default_rng(int(theta * 1000))
    axis = rng.normal(size=3)
    xi = torch.from_numpy(np.concatenate([axis / np.linalg.norm(axis) * theta, rng.normal(size=3)]))
    D = se3.exp_se3(xi)
    ref = torch.func.jacfwd(lambda d: se3.log_se3(se3.exp_se3(d) @ D))(torch.zeros(6, dtype=torch.float64))
    got = ppg._left_jacobian_inv(se3.log_se3(D))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-9)


def test_compose():
    rng = np.random.default_rng(2)
    xi = rng.normal(size=(5, 2, 6)).astype(np.float32) * 0.3
    A, B = se3.exp_se3(torch.from_numpy(xi[:, 0])), se3.exp_se3(torch.from_numpy(xi[:, 1]))
    got = se3.compose(A, B)
    np.testing.assert_array_equal(got.numpy(), (A @ B).numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(jse3.compose(A.numpy(), B.numpy())),
                               atol=1e-6)
    np.testing.assert_allclose(se3.compose(A, se3.inverse(A)).numpy(),
                               np.tile(np.eye(4), (5, 1, 1)), atol=1e-6)


def _sim3_case(mod, name):
    """test_sim3.py's cases, run through one module; returns the arrays."""
    rng = np.random.default_rng(10)
    if name == "so3_roundtrip":
        out = []
        for theta in (0.0, 1e-9, 1e-5, 0.3, 2.0, np.pi - 1e-4):
            axis = rng.normal(size=3)
            R = mod.exp_so3(axis / np.linalg.norm(axis) * theta)
            out += [R, mod.log_so3(R)]
        return out
    if name == "sim3_roundtrip_and_power":
        out = []
        for _ in range(10):
            w = rng.normal(size=3)
            R = mod.exp_so3(w / np.linalg.norm(w) * rng.uniform(0, 2.5))
            s, t = float(np.exp(rng.uniform(-0.6, 0.6))), rng.normal(size=3)
            sig, w2, u = mod.log_sim3(s, R, t)
            out += [np.array([sig]), w2, u, *map(np.atleast_1d, mod.exp_sim3(sig, w2, u)),
                    *map(np.atleast_1d, mod.sim3_power(s, R, t, 0.5))]
        return out
    if name == "small_angle_and_scale":
        return [mod._sim3_W(sig, np.array([th, 0.0, 0.0]))
                for sig in (0.0, 1e-10, 0.3) for th in (0.0, 1e-10, 1e-6)]
    if name == "fit_robust":
        s, R, t = 0.95, mod.exp_so3(np.array([0.02, -0.05, 0.03])), np.array([-0.4, 0.8, 0.0])
        new = rng.normal(size=(40, 3)) * 1.5 + [0, 0, 5]
        old = mod.apply_sim3(s, R, t, new) + rng.normal(size=(40, 3)) * 0.005
        old[:10] = rng.normal(size=(10, 3)) * 4.0  # 25 % wild outliers
        perm = rng.permutation(20)
        fits = [mod.fit_sim3_robust(new, old),
                mod.fit_sim3_robust(new[:20], new[:20][perm] + [1.0, 0.0, 0.0]),
                mod.fit_sim3_robust(rng.normal(size=(12, 3)), rng.normal(size=(12, 3)) * 0.01)]
        assert mod.fit_sim3_robust(np.zeros((3, 3)), np.ones((3, 3))) is None
        return [np.atleast_1d(x) for f in fits if f is not None for x in f] + \
            [np.array([f is None for f in fits])]
    # corrected_pose
    Tcw = np.eye(4)
    Tcw[:3, :3] = mod.exp_so3(rng.normal(size=3) * 0.4)
    Tcw[:3, 3] = rng.normal(size=3)
    return [mod.corrected_pose(Tcw, 1.07, mod.exp_so3(np.array([0.1, 0.2, -0.1])),
                               np.array([0.3, -0.1, 0.2])), np.array([mod.rotation_angle(Tcw[:3, :3])])]


@pytest.mark.parametrize("name", ["so3_roundtrip", "sim3_roundtrip_and_power",
                                  "small_angle_and_scale", "fit_robust", "corrected_pose"])
def test_sim3_copy_matches_jax(name):
    got, ref = _sim3_case(sim3, name), _sim3_case(jsim3, name)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=1e-6)
