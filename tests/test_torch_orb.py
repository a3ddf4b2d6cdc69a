"""Port parity: ORB extraction (plain path) and Hamming matching against the
JAX package.

Extraction is compared by feature SET (tests/test_pallas_detect.py:114-165):
>= 95 % of valid keypoints in common keyed on (x, y, octave) to 1 decimal,
>= 90 % of common descriptors bit-identical and none more than 16 bits
apart. Top-k ties come out in another order, and the pyramid's matmuls
reassociate float sums, so slots are never compared one by one. Hamming
matching is exact: integer distances, first-index ties, strict '<'.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import compare_feature_sets, jax_features_np, t32
from test_orb import textured_image
from mono_slam_framework_tpu.ops import filters as jfilters
from mono_slam_framework_tpu.ops import hamming as jhamming
from mono_slam_framework_tpu.ops import orb as jorb
from mono_slam_framework_torch import convert, sim
from mono_slam_framework_torch.ops import hamming, orb


@functools.partial(jax.jit, static_argnames=("max_features",))
def _jax_extract(img, max_features):
    return jorb.extract(img, max_features, use_fused=False)


def _images():
    rng = np.random.default_rng(3)
    # both images 240x320, so the second test reuses the first's JAX compile
    smooth = np.asarray(jfilters.gaussian_blur(
        jnp.asarray(rng.uniform(0, 255, (240, 320)).astype(np.float32)), size=5, sigma=1.2
    ))
    world = sim.PlaneWorld(width=320, height=240, f=250.0, second_plane=(3.0, 0.3))
    view = world.render(sim.lateral_trajectory(2, step=0.05)[1])
    return {"smooth": smooth, "plane_world": view}


@pytest.mark.parametrize("name", ["smooth", "plane_world"])
def test_extract_matches_jax(name):
    img = _images()[name]
    ref = jax_features_np(_jax_extract(jnp.asarray(img), 300))
    got = orb.extract(t32(img), 300)
    assert got.desc.dtype == torch.int32 and got.xy.shape == (300, 2)
    compare_feature_sets(convert.features_to_numpy(got), ref)
    assert got.valid.sum() > 100


def test_golden_extraction():
    g = np.load(os.path.join(os.path.dirname(__file__), "data", "orb_golden.npz"))
    img = textured_image(np.random.default_rng(int(g["img_seed"])))
    got = convert.features_to_numpy(orb.extract(t32(img), 300))
    golden = {k: g[k] for k in ("xy", "desc", "valid", "octave")}
    compare_feature_sets(got, golden)


def test_tables_match():
    pts, perm = orb._brief_pattern_np()
    jpts, jperm = jorb._brief_pattern_np()
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(perm, jperm)
    for total in (300, 512, 2000, 7):
        assert orb._per_level_budget(total) == jorb._per_level_budget(total)
    for hw in ((480, 640), (240, 320), (200, 256)):
        assert list(orb._level_dims(*hw)) == list(jorb._level_dims(*hw))
    for n_in, n_out in ((640, 533), (480, 134), (320, 89), (100, 100)):
        np.testing.assert_array_equal(
            orb._bilinear_weight_mat(n_in, n_out), jorb._bilinear_weight_mat(n_in, n_out)
        )


def test_pack_bits_layout():
    # bit i of word j is bit 32*j + i, as the JAX package's uint32 words;
    # every word's bit 31 is set, so every int32 word is negative
    bits = np.random.default_rng(4).integers(0, 2, (5, 256)).astype(bool)
    bits[:, 31::32] = True
    ref = (bits.reshape(5, 8, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    got = orb.pack_bits(torch.from_numpy(bits)).numpy()
    assert (got < 0).all()
    np.testing.assert_array_equal(got.view(np.uint32), ref.astype(np.uint32))
    np.testing.assert_array_equal(hamming.unpack_bits(torch.from_numpy(got)).numpy(), bits)
    np.testing.assert_array_equal(
        np.asarray(jhamming.unpack_bits(jnp.asarray(got.view(np.uint32)))), bits
    )


@pytest.fixture(scope="module")
def descs():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2**32, size=(40, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(30, 8), dtype=np.uint32)
    b[7] = b[3]  # duplicate train rows: distance ties resolve to the first
    a[:5] = b[:5] ^ np.uint32(1)  # near matches
    va = np.ones(40, bool)
    vb = np.ones(30, bool)
    va[[10, 11]] = False  # all-invalid query rows
    vb[[20, 21, 22]] = False
    return a, b, va, vb


def test_distance_matrix_exact(descs):
    a, b, va, vb = descs
    ref = np.asarray(jhamming.distance_matrix(*map(jnp.asarray, descs)))
    got = hamming.distance_matrix(
        torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32)),
        torch.from_numpy(va), torch.from_numpy(vb),
    ).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.isinf(got[10]).all() and np.isinf(got[:, 20]).all()


@pytest.mark.parametrize("ratio", [0.5, 0.7, 1.0])
def test_knn2_ratio_match_exact(descs, ratio):
    d = np.array(jhamming.distance_matrix(*map(jnp.asarray, descs)))
    # row 12: best 50, second 100 — at ratio 0.5 best == ratio * second
    # exactly, and the strict '<' rejects it
    d[12] = 120.0
    d[12, 4] = 50.0
    d[12, 9] = 100.0
    idx_r, ok_r = jhamming.knn2_ratio_match(jnp.asarray(d), ratio)
    idx, ok = hamming.knn2_ratio_match(torch.from_numpy(d), ratio)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_r))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    assert not ok[10] and not ok[11] and idx[10] == 0  # all-invalid rows
    assert idx[3] == 3  # train rows 3 and 7 tie: the first wins
    assert bool(ok[12]) == (ratio > 0.5)
