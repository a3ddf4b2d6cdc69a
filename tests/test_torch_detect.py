"""Port parity: kernel B1's plain version (ops/detect.py) against the JAX
package's XLA maps, its per-level Pallas kernel and its whole-pyramid
Pallas kernel (interpret mode); the kernel's launch plan and the order of
its running moment sums; plus kernel B1 against the plain version on a card.

Tolerances are those of tests/test_pallas_detect.py:36-77 on interior
pixels: score rtol 1e-5 / atol 1e-2 with an identical finite pattern,
Harris 5e-4 / 1, moments 1e-4 / 2, blur 1e-5 / 1e-3 (f32 reassociation of
the filter sums).
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_parity import interior, require_cuda, t32
from mono_slam_framework_tpu.ops import fast as jfast
from mono_slam_framework_tpu.ops import filters as jfilters
from mono_slam_framework_tpu.ops import orb as jorb
from mono_slam_framework_tpu.ops import pallas_detect
from mono_slam_framework_torch.ops import detect, fast, orb

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


@pytest.mark.parametrize("dims", [
    tuple(orb._level_dims(480, 640)), tuple(orb._level_dims(240, 320)),
    ((67, 89),), ((136, 168),), ((31, 40), (20, 27)),
], ids=["640x480", "240x320", "67x89", "136x168", "tiny"])
def test_tile_plan_covers_every_pixel_once(dims):
    """Every pixel of the [rows, w0] stack belongs to exactly one tile; a
    tile wholly past its level's width is a pad-only tile."""
    plan = detect.tile_plan(dims)
    _, rows, w0 = detect.level_layout(dims)
    gx, gy = plan.grid
    assert gx * detect.TILE_COLS >= w0
    seen = np.zeros((rows, w0), int)
    n_pad = 0
    for by in range(gy):
        # the tile's level: the last whose first tile row is <= by
        row0, h, w, t0 = [lv for lv in plan.table if lv[3] <= by][-1]
        y0 = (by - t0) * detect.TILE_ROWS
        assert y0 < h
        for bx in range(gx):
            x0 = bx * detect.TILE_COLS
            seen[row0 + y0: row0 + min(h, y0 + detect.TILE_ROWS), x0: x0 + detect.TILE_COLS] += 1
            n_pad += x0 >= w
    assert (seen == 1).all()
    assert n_pad == plan.pad_tiles
    assert detect.SMEM_BYTES <= 232_448  # 227 KB per block


def test_tile_shape_matches_the_kernel():
    src = (pathlib.Path(detect.__file__).parents[1] / "csrc" / "detect.cu").read_text()
    th = int(re.search(r"constexpr int TH = (\d+);", src).group(1))
    tw = int(re.search(r"constexpr int TW = (\d+);", src).group(1))
    assert (th, tw) == (detect.TILE_ROWS, detect.TILE_COLS)
    assert f"Shared memory: {detect.SMEM_BYTES:,} B per block" in src


def _running_moments(img, seg=16, r=15):
    """m10 / m01 of an [h, w] level in the kernel's order: reads clamped to
    the level; f64 running box and ramp sums of 31 pixels along each row,
    restarted every `seg` columns and stored in f32; then the same down each
    column over those row sums, restarted every `seg` rows."""
    h, w = img.shape
    H, W = -(-h // seg) * seg, -(-w // seg) * seg  # whole segments
    p = F.pad(img.double()[None, None], (r, r + W - w, r, r + H - h), mode="replicate")[0, 0]

    def walks(a):  # along the last axis of a [n, L + 2r] f64 tensor -> box, ramp [n, L]
        d = torch.arange(-r, r + 1, dtype=torch.float64)
        L = a.shape[1] - 2 * r
        box = torch.empty(a.shape[0], L, dtype=torch.float64)
        ramp = torch.empty_like(box)
        xs = torch.arange(0, L, seg)
        win = a[:, xs[:, None] + torch.arange(2 * r + 1)]  # [n, segments, 31]
        b, rp = win.sum(-1), (win * d).sum(-1)
        box[:, xs], ramp[:, xs] = b, rp
        for k in range(1, seg):
            leave, enter = a[:, xs + k - 1], a[:, xs + k + 2 * r]
            b = b + (enter - leave)
            rp = rp + (15.0 * leave + 16.0 * enter - b)
            box[:, xs + k], ramp[:, xs + k] = b, rp
        return box, ramp

    hb, hr = (x.float().double() for x in walks(p))  # rows -r .. H + r, stored in f32
    m10, _ = walks(hr.T.contiguous())  # down the columns: box of the row ramps
    _, m01 = walks(hb.T.contiguous())  # ramp of the row boxes
    return m10.T[:h, :w].float(), m01.T[:h, :w].float()


def test_running_sum_moments_match_plain_and_jax():
    """The kernel's running-sum order stays within check_b1's moment
    tolerances of the plain maps at every level of a 240x320 pyramid, and of
    the JAX package's at its largest and smallest level (each level shape
    costs JAX a compile)."""
    import chip_smoke

    _, _, images = chip_smoke.render(chip_smoke.SMALL._replace(n_frames=1))
    dims = orb._level_dims(*images[0].shape)
    stack = orb.pyramid(torch.from_numpy(images[0]))
    row0, _, _ = detect.level_layout(tuple(dims))
    for i, ((h, w), r0) in enumerate(zip(dims, row0)):
        lvl = stack[r0: r0 + h, :w]
        got = _running_moments(lvl)
        mask = interior((h, w))
        refs = [detect.moment_maps(lvl)]
        if i in (0, len(dims) - 1):
            refs.append(jorb._moment_maps(jnp.asarray(lvl.numpy())))
        for ref in refs:
            for g, rf in zip(got, ref):
                np.testing.assert_allclose(g.numpy()[mask], np.asarray(rf)[mask],
                                           rtol=TOL["m10"][0], atol=TOL["m10"][1])


@pytest.mark.cuda
def test_kernel_b1_matches_plain():
    require_cuda()
    import chip_smoke

    _, _, images = chip_smoke.render(chip_smoke.SMALL._replace(n_frames=1))
    chip_smoke.check_b1(images[0], torch.device("cuda"))
