"""Port parity: the plain pose LM (kernel B2's plain version) against the
JAX package's XLA path, its Pallas kernel (interpret mode) and the f64
oracle; plus kernel B2 against the plain version on a card.

Tolerances are those of tests/test_optim.py:97-123 (T atol 1e-4, inlier
agreement > 0.98, n_good +- 2: f32 reassociation noise) and the oracle's
|dRMSE| < 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_oracle
from torch_parity import require_cuda, t32
from test_optim import K, make_pose_problem, rmse_pose
from mono_slam_framework_tpu.optim import pose_opt as jpose_opt
from mono_slam_framework_tpu.optim import pose_opt_pallas
from mono_slam_framework_torch.optim import pose_opt, pose_opt_cuda


@pytest.fixture(scope="module")
def problem():
    """Outliers, 7 padded edges and per-edge info, as the Pallas parity test."""
    rng = np.random.default_rng(0)
    T_true, T0, X, uv, _ = make_pose_problem(rng, noise=0.8, n_outliers=8)
    valid = np.ones(len(X), bool)
    valid[-7:] = False
    info = rng.uniform(0.5, 1.5, len(X)).astype(np.float32)
    return T0, X, uv, valid, info


def _port(T0, X, uv, valid, info=None):
    return pose_opt.pose_optimize(
        t32(T0), t32(X), t32(uv), torch.from_numpy(valid), t32(K),
        None if info is None else t32(info),
    )


def _jax_args(T0, X, uv, valid, info):
    return (
        jnp.asarray(T0, jnp.float32), jnp.asarray(X, jnp.float32),
        jnp.asarray(uv, jnp.float32), jnp.asarray(valid), jnp.asarray(K),
        jnp.asarray(info),
    )


def _assert_close(got, ref):
    T_g, in_g, ng_g = (np.asarray(x) for x in got)
    T_r, in_r, ng_r = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(T_g, T_r, atol=1e-4)
    assert (in_g == in_r).mean() > 0.98
    assert abs(int(ng_g) - int(ng_r)) <= 2


def test_matches_xla_path(problem):
    ref = jpose_opt.pose_optimize(*_jax_args(*problem), use_pallas=False)
    got = [x.numpy() for x in _port(*problem)]
    _assert_close(got, ref)


def test_matches_pallas_kernel(problem):
    ref = pose_opt_pallas.pose_optimize_pallas(*_jax_args(*problem), interpret=True)
    got = [x.numpy() for x in _port(*problem)]
    _assert_close(got, ref)


@pytest.mark.parametrize("with_info", [False, True], ids=["identity", "per_edge_info"])
def test_parity_with_f64_oracle(with_info):
    rng = np.random.default_rng(1)
    _, T0, X, uv, _ = make_pose_problem(rng, noise=0.8)
    valid = np.ones(len(X), bool)
    info = rng.uniform(0.5, 1.5, len(X)) if with_info else None
    T_opt, inlier, _ = _port(T0, X, uv, valid, info)
    T_ref, inlier_ref = lm_oracle.pose_optimize_oracle(T0, X, uv, valid, K, info)
    m = inlier.numpy() & inlier_ref
    r_port = rmse_pose(T_opt.numpy(), X, uv, m)
    r_ref = rmse_pose(T_ref, X, uv, m)
    assert abs(r_port - r_ref) < 1e-3, (r_port, r_ref)


def test_padding_invariance():
    rng = np.random.default_rng(2)
    _, T0, X, uv, _ = make_pose_problem(rng)
    info = rng.uniform(0.5, 1.5, len(X))
    Xp = np.concatenate([X, rng.uniform(-1, 1, (40, 3))])  # junk behind the mask
    uvp = np.concatenate([uv, rng.uniform(0, 640, (40, 2))])
    infop = np.concatenate([info, np.ones(40)])
    valid = np.concatenate([np.ones(len(X), bool), np.zeros(40, bool)])
    T_a, in_a, ng_a = _port(T0, X, uv, np.ones(len(X), bool), info)
    T_b, in_b, ng_b = _port(T0, Xp, uvp, valid, infop)
    assert int(ng_a) == int(ng_b)
    assert not in_b[len(X):].any()  # padded edges are never inliers
    np.testing.assert_array_equal(in_a.numpy(), in_b[: len(X)].numpy())
    np.testing.assert_allclose(T_a.numpy(), T_b.numpy(), atol=1e-5)


def test_f64_runs_in_f64():
    rng = np.random.default_rng(3)
    _, T0, X, uv, _ = make_pose_problem(rng)
    T, _, ng = pose_opt.pose_optimize(
        torch.from_numpy(T0), torch.from_numpy(X), torch.from_numpy(uv),
        torch.ones(len(X), dtype=torch.bool), torch.from_numpy(K.astype(np.float64)),
    )
    assert T.dtype == torch.float64 and int(ng) > 100


def test_kernel_wrapper_refuses_cpu_tensors(problem):
    # the kernel path never takes a CPU tensor (and never falls back)
    T0, X, uv, valid, info = problem
    with pytest.raises(ValueError, match="CUDA"):
        pose_opt_cuda.pose_lm_batched(
            t32(T0)[None], t32(X)[None], t32(uv)[None], t32(valid)[None],
            t32(info)[None], t32([[500.0, 500.0, 320.0, 240.0]]),
        )


@pytest.mark.cuda
def test_kernel_b2_matches_plain():
    require_cuda()
    import chip_smoke

    chip_smoke.check_b2(torch.device("cuda"))
