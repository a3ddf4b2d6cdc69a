"""Port parity for the per-level detection path: B1 launched over one level
(`ops/detect.py::detect_level`, the Hopper form of the JAX package's
`_banded_kernel` and `_full_kernel`) against `pallas_detect.detect_stage`
in interpret mode, at a level taller than 96 rows (the banded kernel) and
one of at most 96 (the whole-level kernel); and `orb.extract(per_level=True)`
against the one-launch path. On the CPU the level runs `level_maps_plain`;
the `cuda` tests run chip_smoke's checks of the kernel itself.

Tolerances: those of tests/test_torch_detect.py (score rtol 1e-5 / atol
1e-2 with an identical finite pattern, Harris 5e-4 / 1, moments 1e-4 / 2,
blur 1e-5 / 1e-3 on interior pixels); the two extract paths are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import interior, require_cuda, t32
from test_torch_detect import _assert_maps
from mono_slam_framework_tpu.ops import pallas_detect
from mono_slam_framework_torch.ops import detect, orb


def _texture(h, w, seed):
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (-(-h // 8), -(-w // 8))).astype(np.float32)
    return np.kron(coarse, np.ones((8, 8), np.float32))[:h, :w].copy()


@pytest.mark.parametrize(
    "h,w,form",
    [(136, 168, "banded"), (90, 120, "full"), (67, 89, "full")],
)
def test_one_level_matches_detect_stage(h, w, form):
    """detect_stage picks _banded_kernel above 96 rows and _full_kernel at
    or below; one-level detect_maps and detect_level give its maps."""
    assert (h <= pallas_detect._SMALL_ROWS) == (form == "full")
    img = _texture(h, w, seed=h)
    ref = pallas_detect.detect_stage(jnp.asarray(img), 20.0, 31, interpret=True)
    one = detect.detect_maps(t32(img), ((h, w),), 20.0, 31)
    lvl = detect.detect_level(t32(img), 20.0, 31)
    for a, b in zip(one, lvl):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    _assert_maps([m.numpy() for m in lvl], ref, interior((h, w)))
    if h > 2 * 31 + 2:
        assert np.isfinite(lvl.score.numpy()).sum() > 0


def test_per_level_stack_equals_one_launch_layout():
    dims = orb._level_dims(96, 128)
    stack = orb.pyramid(t32(_texture(96, 128, 3)))
    a = detect.detect_maps(stack, dims)
    b = detect.detect_maps_per_level(stack, dims)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_extract_per_level_equals_one_launch():
    """The 240x320 view has levels of 96, 80 and 67 rows (the whole-level
    form) below five banded-form levels."""
    import chip_smoke

    _, _, images = chip_smoke.render(chip_smoke.SMALL._replace(n_frames=1))
    dims = orb._level_dims(*images[0].shape)
    assert [h for h, _ in dims][5:] == [96, 80, 67]
    img = torch.from_numpy(images[0])
    one = orb.extract(img, 512)
    per = orb.extract(img, 512, per_level=True)
    for name, a, b in zip(orb.Features._fields, one, per):
        assert torch.equal(a, b), name
    assert int(one.valid.sum()) > 300


def test_level_launch_needs_cuda():
    with pytest.raises(ValueError, match="CUDA"):
        detect.detect_level_cuda(torch.zeros(40, 48))


@pytest.mark.cuda
def test_kernel_one_level_launches_match_plain():
    require_cuda()
    import chip_smoke

    dev = torch.device("cuda")
    _, _, images = chip_smoke.render(chip_smoke.SMALL._replace(n_frames=1))
    rec = chip_smoke.check_b1_per_level(images[0], dev)
    assert rec["forms"][5:] == ["full"] * 3


@pytest.mark.cuda
def test_kernel_extract_per_level_equals_one_launch():
    require_cuda()
    import chip_smoke

    _, _, images = chip_smoke.render(chip_smoke.SMALL._replace(n_frames=1))
    chip_smoke.check_extract_per_level(images[0], torch.device("cuda"), 512)
