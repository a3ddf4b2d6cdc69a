"""Port parity: the plain pose LM (kernel B2's plain version) against the
JAX package's XLA path, its Pallas kernel (interpret mode) and the f64
oracle; the plain batched twin of the kernel's launcher; the reclassification
from the carried chi2; B2's launch plan; plus kernel B2 against the plain
version on a card.

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
from mono_slam_framework_torch.optim import lm, pose_opt, pose_opt_cuda


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
            t32(T0)[None], t32(X)[None], t32(uv)[None], torch.from_numpy(valid)[None],
            t32(K)[None], t32(info)[None],
        )


def _batch():
    """Three problems of 160 slots with 0, 25 and 70 padded and three cameras
    (chip_smoke.b2_batch_problems' construction at a CPU size)."""
    import chip_smoke

    probs = [chip_smoke.pose_problem(seed, 160, 10, pad, f, c) for seed, pad, f, c in (
        (1, 0, 500.0, (320.0, 240.0)), (2, 25, 420.0, (300.0, 250.0)),
        (3, 70, 610.0, (330.0, 230.0)))]
    return [np.stack(xs) for xs in zip(*probs)]


def test_batched_plain_matches_per_problem_and_pallas():
    T0, X, uv, valid, Ks, info = _batch()
    T, inlier, n_good = pose_opt.pose_lm_batched_plain(
        t32(T0), t32(X), t32(uv), torch.from_numpy(valid), t32(Ks), t32(info))
    assert T.shape == (3, 4, 4) and inlier.dtype == torch.bool and n_good.dtype == torch.int32
    assert not (inlier & ~torch.from_numpy(valid)).any()  # ANDed with valid
    for i in range(3):
        one = pose_opt.pose_optimize_plain(
            t32(T0[i]), t32(X[i]), t32(uv[i]), torch.from_numpy(valid[i]), t32(Ks[i]),
            t32(info[i]))
        for a, b in zip((T[i], inlier[i], n_good[i]), one):
            assert torch.equal(a, b.to(a.dtype))
        ref = pose_opt_pallas.pose_optimize_pallas(
            jnp.asarray(T0[i]), jnp.asarray(X[i]), jnp.asarray(uv[i]), jnp.asarray(valid[i]),
            jnp.asarray(Ks[i]), jnp.asarray(info[i]), interpret=True)
        _assert_close([T[i].numpy(), inlier[i].numpy(), n_good[i]], ref)


def test_reclassification_from_carried_chi2_equals_fresh_pass(problem):
    """Each round's carried chi2 is that of the pose the round returns, so
    reclassifying from it gives the inliers a fresh pass at that pose gives."""
    T0, X, uv, valid, info = problem
    T0, X, uv, Kt, info = (t32(a) for a in (T0, X, uv, K, info))
    valid = torch.from_numpy(valid)
    inlier = torch.ones_like(valid)
    changed = 0
    for rnd in range(pose_opt.N_ROUNDS):
        mask = (valid & inlier).to(torch.float32)
        T, e2 = pose_opt._round(T0, X, uv, Kt, mask, info, use_huber=rnd < 3)
        _, e2_fresh, _, _ = pose_opt._edge_terms(T, X, uv, Kt, mask, info, False)
        torch.testing.assert_close(e2, e2_fresh, rtol=0, atol=0)
        new = e2 <= lm.CHI2_MONO
        changed += int((new != inlier).sum())
        inlier = new
    assert changed > 0  # the outliers were reclassified


@pytest.mark.parametrize("E", [0, 1, 2000, 50_000])
@pytest.mark.parametrize("cluster", pose_opt_cuda.CLUSTERS)
def test_lm_plan_covers_every_slot_once(E, cluster):
    plan = pose_opt_cuda.lm_plan(E, cluster)
    assert plan.cluster == cluster and plan.slice % 16 == 0 and plan.resident % 16 == 0
    assert 0 <= plan.resident <= plan.slice
    seen = np.zeros(E, int)
    for r in range(cluster):  # CTA r's slots: resident ones, then device-memory ones
        lo, hi = min(E, r * plan.slice), min(E, (r + 1) * plan.slice)
        seen[lo:hi] += 1
        assert hi - lo <= plan.slice
    assert (seen == 1).all()
    # at most 227 KB per CTA, as csrc/pose_lm.cu::layout lays it out
    assert plan.smem == 1216 + 256 * cluster + 62 * plan.resident <= 232_448
    # slots beyond the shared memory are read from device memory; below it
    # every slot is resident
    full = pose_opt_cuda.lm_plan(E + 10**6, cluster).resident
    assert plan.resident == min(plan.slice, full)


@pytest.mark.cuda
def test_kernel_b2_matches_plain():
    require_cuda()
    import chip_smoke

    chip_smoke.check_b2(torch.device("cuda"))


@pytest.mark.cuda
def test_kernel_b2_every_cluster_size_matches_plain():
    require_cuda()
    import chip_smoke

    chip_smoke.b2_cluster_sweep(torch.device("cuda"))
