"""Port parity: kernel B1's plain version (ops/detect.py) against the JAX
package's XLA maps, its per-level Pallas kernel and its whole-pyramid
Pallas kernel (interpret mode); plus kernel B1 against the plain version on
a card.

Tolerances are those of tests/test_pallas_detect.py:36-77 on interior
pixels: score rtol 1e-5 / atol 1e-2 with an identical finite pattern,
Harris 5e-4 / 1, moments 1e-4 / 2, blur 1e-5 / 1e-3 (f32 reassociation of
the filter sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import interior, require_cuda, t32
from mono_slam_framework_tpu.ops import fast as jfast
from mono_slam_framework_tpu.ops import filters as jfilters
from mono_slam_framework_tpu.ops import orb as jorb
from mono_slam_framework_tpu.ops import pallas_detect
from mono_slam_framework_torch.ops import detect, fast

TOL = {"score": (1e-5, 1e-2), "m10": (1e-4, 2.0), "m01": (1e-4, 2.0),
       "blur": (1e-5, 1e-3), "harris": (5e-4, 1.0)}
NAMES = tuple(TOL)


@pytest.fixture(scope="module")
def img():
    rng = np.random.default_rng(0)
    return np.kron(rng.uniform(0, 255, (16, 20)).astype(np.float32), np.ones((8, 8)))


@pytest.fixture(scope="module")
def port_maps(img):
    h, w = img.shape
    return [m.numpy() for m in detect.detect_maps(t32(img), ((h, w),), 20.0, 31)]


def _assert_maps(got, ref, mask):
    """got/ref: sequences of the five maps; compare on `mask`."""
    for name, g, r in zip(NAMES, got, ref):
        g, r = np.asarray(g)[mask], np.asarray(r)[mask]
        if name == "score":
            assert (np.isfinite(g) == np.isfinite(r)).all()
        fin = np.isfinite(g) & np.isfinite(r)
        rtol, atol = TOL[name]
        np.testing.assert_allclose(g[fin], r[fin], rtol=rtol, atol=atol, err_msg=name)


def test_matches_xla_maps(img, port_maps):
    ji = jnp.asarray(img)
    h, w = img.shape
    is_c, _ = jfast.fast_score_map(ji, 20.0)
    harris = jfast.harris_response(ji)
    yy, xx = jnp.arange(h)[:, None], jnp.arange(w)[None, :]
    inside = (yy >= 31) & (yy < h - 31) & (xx >= 31) & (xx < w - 31)
    cand = jnp.where(is_c & inside, harris, -jnp.inf)
    score = jnp.where(cand >= jfilters.max_pool_3x3_same(cand), cand, -jnp.inf)
    m10, m01 = jorb._moment_maps(ji)
    ref = (score, m10, m01, jfilters.gaussian_blur(ji), harris)
    _assert_maps(port_maps, ref, interior(img.shape))
    assert np.isfinite(port_maps[0]).sum() > 10  # the texture has corners


def test_matches_pallas_detect_stage(img, port_maps):
    ref = pallas_detect.detect_stage(jnp.asarray(img), 20.0, 31, interpret=True)
    _assert_maps(port_maps, ref, interior(img.shape))


def test_corner_mask_matches_fast(img):
    # the same circular rolls, so the mask agrees everywhere, border included
    is_c, _ = jfast.fast_score_map(jnp.asarray(img), 20.0)
    np.testing.assert_array_equal(fast.corner_mask(t32(img), 20.0).numpy(), np.asarray(is_c))


def test_multi_level_matches_pallas_multi():
    """The row-stacked whole-pyramid layout against detect_stage_multi, per
    level (the JAX layout pads each level to 64-row bands)."""
    rng = np.random.default_rng(7)
    h0, w0 = 200, 160
    base = jfilters.gaussian_blur(
        jnp.asarray(rng.uniform(0, 255, (h0, w0)).astype(np.float32)), size=5, sigma=1.2
    )
    dims = jorb._level_dims(h0, w0)
    imgs = [base] + [jfilters.resize_bilinear(base, dims[l]) for l in range(1, len(dims))]
    outs, starts = pallas_detect.detect_stage_multi(tuple(imgs), 10.0, 31, interpret=True)
    stack = np.zeros((sum(h for h, _ in dims), w0), np.float32)
    row0, rows, width = detect.level_layout(tuple(dims))
    assert (rows, width) == stack.shape
    for im, r in zip(imgs, row0):
        stack[r : r + im.shape[0], : im.shape[1]] = np.asarray(im)
    got = [m.numpy() for m in detect.detect_maps(t32(stack), dims, 10.0, 31)]
    n_corners = 0
    for l, (h, w) in enumerate(dims):
        mine = [m[row0[l] : row0[l] + h, :w] for m in got]
        ref = [np.asarray(o)[starts[l] : starts[l] + h, :w] for o in outs]
        _assert_maps(mine, ref, interior((h, w)))
        n_corners += int(np.isfinite(mine[0]).sum())
        # padded columns: score -inf, the other maps 0
        assert np.isneginf(got[0][row0[l] : row0[l] + h, w:]).all()
        for m in got[1:]:
            assert (m[row0[l] : row0[l] + h, w:] == 0).all()
    assert n_corners > 10


def test_layout_is_checked():
    dims = ((40, 48), (33, 40))
    assert detect.level_layout(dims) == ((0, 40), 73, 48)
    with pytest.raises(ValueError, match="layout"):
        detect.detect_maps(torch.zeros(72, 48), dims)
    with pytest.raises(TypeError):
        detect.detect_maps(torch.zeros(73, 48, dtype=torch.float64), dims)
    with pytest.raises(ValueError, match="CUDA"):
        detect.detect_maps_cuda(torch.zeros(73, 48), dims)


@pytest.mark.cuda
def test_kernel_b1_matches_plain():
    require_cuda()
    import chip_smoke

    _, _, images = chip_smoke.render(chip_smoke.SMALL._replace(n_frames=1))
    chip_smoke.check_b1(images[0], torch.device("cuda"))
