"""Port parity: optim/bundle_adjust.py against the JAX package's, on
tests/test_optim.py's BA cases.

Each problem is built by the JAX package's `build_problem` (pow2-padded)
and carried over with `convert.ba_problem_from_numpy`, so both solvers see
the same edges, padding included. Tolerance: poses within 1e-3 absolute,
points within 1e-3 relative to their coordinates (they sit 4-10 units deep
along a weakly observed depth axis), the same outlier flags, and the fixed
camera bit-identical. The f32 spread is JAX's: on the local-BA case its f32
points are 2.9e-3 from an f64 solve of the same problem and the port's f32
points 3.0e-4, which test_local_ba_flags_the_same_outliers holds at 1e-3.
The port's own `build_problem` (no padding) gives the same result.
"""

import importlib

import numpy as np
import pytest

import torch_parity  # noqa: F401  (pins torch to one thread)
from test_optim import K, make_ba_problem
from mono_slam_framework_torch import convert
from mono_slam_framework_torch.optim import bundle_adjust as ba

# the JAX package's optim/__init__ re-exports a function under the module's name
jba = importlib.import_module("mono_slam_framework_tpu.optim.bundle_adjust")
TOL = 1e-3


def _problem(seed, n_cams=4, n_pts=60, outliers=0, info=False, with_pairs=True):
    rng = np.random.default_rng(seed)
    cams_true, cams0, fixed, X, X0, e_cam, e_pt, e_uv = make_ba_problem(
        rng, n_cams=n_cams, n_pts=n_pts
    )
    e_uv = e_uv.copy()
    if outliers:
        out = rng.choice(len(e_cam), outliers, replace=False)
        e_uv[out] += rng.uniform(40, 100, (outliers, 2))
    e_info = (1.2 ** (-2.0 * rng.integers(0, 8, len(e_cam)))).astype(np.float32) if info else None
    args = (np.stack(cams0).astype(np.float32), fixed, X0.astype(np.float32),
            e_cam, e_pt, e_uv.astype(np.float32), K)
    pj = jba.build_problem(*args, e_info=e_info, with_pairs=with_pairs)
    pt = convert.ba_problem_from_numpy(pj, device="cpu")
    own = ba.build_problem(*args, e_info=e_info, with_pairs=with_pairs, device="cpu")
    return pj, pt, own, len(e_cam)


def _assert_close(got, ref, n_pts):
    T, X = got[0].numpy(), got[1].numpy()
    Tj, Xj = np.asarray(ref[0]), np.asarray(ref[1])
    np.testing.assert_allclose(T[: len(T)], Tj[: len(T)], atol=TOL)
    np.testing.assert_allclose(X[:n_pts], Xj[:n_pts], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("robust,info", [(True, False), (False, False), (False, True)])
def test_dense_ba_matches_jax(robust, info):
    pj, pt, own, _ = _problem(0, n_cams=3, n_pts=40, info=info)
    ref = jba.bundle_adjust(pj, n_iters=15, robust=robust)
    got = ba.bundle_adjust(pt, n_iters=15, robust=robust)
    _assert_close(got, ref, 40)
    # the fixed camera passes through bit-exact
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(pj.cam_T[0]))
    unpadded = ba.bundle_adjust(own, n_iters=15, robust=robust)
    _assert_close(unpadded, ref, 40)


def test_local_ba_flags_the_same_outliers():
    pj, pt, own, n_edges = _problem(1, outliers=15)
    Tj, Xj, bad_j, _ = jba.local_bundle_adjust(pj)
    T, X, bad, _ = ba.local_bundle_adjust(pt)
    _assert_close((T, X), (Tj, Xj), 60)
    np.testing.assert_array_equal(bad.numpy(), np.asarray(bad_j))
    assert 15 <= bad.numpy()[:n_edges].sum() < 0.25 * n_edges
    _, _, bad_own, _ = ba.local_bundle_adjust(own)
    np.testing.assert_array_equal(bad_own.numpy(), np.asarray(bad_j)[:n_edges])
    # the same problem in f64: the port's f32 solve stays within 1e-3 of it
    f64 = {k: getattr(pt, k).double() for k in ("cam_T", "points", "e_uv", "e_info", "K")}
    T6, X6, bad6, _ = ba.local_bundle_adjust(pt._replace(**f64))
    np.testing.assert_allclose(X.numpy()[:60], X6.numpy()[:60], atol=TOL)
    np.testing.assert_allclose(T.numpy(), T6.numpy(), atol=TOL)
    np.testing.assert_array_equal(bad6.numpy(), bad.numpy())


def test_pcg_global_ba_matches_jax():
    pj, pt, own, _ = _problem(2, with_pairs=False)
    assert not pt.pair_valid.any()  # no pair list was built
    ref = jba.global_bundle_adjust(pj, n_iters=20, robust=True, cg_iters=80)
    got = ba.global_bundle_adjust(pt, n_iters=20, robust=True, cg_iters=80)
    _assert_close(got, ref, 60)
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(pj.cam_T[0]))
    # PCG and the dense solve land on the same optimum
    _, dense, _, _ = _problem(2)
    dense_out = ba.bundle_adjust(dense, n_iters=20, robust=True)
    np.testing.assert_allclose(got[0].numpy()[:4], dense_out[0].numpy()[:4], atol=TOL)


def test_edge_pairs_match_jax_list():
    """The vectorized pair list holds the JAX package's pairs in its order."""
    pj, pt, _, _ = _problem(3, n_cams=3, n_pts=30)
    n = int(np.asarray(pj.pair_valid).sum())
    np.testing.assert_array_equal(pt.pair_i.numpy()[:n], np.asarray(pj.pair_i)[:n])
    np.testing.assert_array_equal(pt.pair_j.numpy()[:n], np.asarray(pj.pair_j)[:n])


@pytest.mark.parametrize("inner", [(), (6,), (6, 3)])
def test_segment_sums_add_in_edge_order(inner):
    """Each segment is summed in edge order: bit-equal to the CPU's
    index_add_, whatever order the segments' rows come in, and empty
    segments sum to 0 (the card sums the same way, so it reproduces the
    CPU's sums run after run)."""
    import torch

    rng = np.random.default_rng(4)
    n, E = 50, 4000
    idx = torch.from_numpy(rng.integers(0, n - 5, E))  # the last 5 segments stay empty
    x = torch.from_numpy(rng.normal(size=(E, *inner)).astype(np.float32) * 1e3)
    seg = ba._segments(idx, n)
    got = ba._segment_sum(x, seg)
    ref = torch.zeros((n, *inner)).index_add_(0, idx, x)
    assert torch.equal(got, ref)
    assert seg.lengths.tolist() == np.bincount(idx.numpy(), minlength=n).tolist()
    assert not got[-5:].any()
