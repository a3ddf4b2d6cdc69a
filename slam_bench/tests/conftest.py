"""Shared pieces of the benchmark's tests: the small CPU sizes the tests
drive the harness at, and the card fixture of the `cuda` tests (decided
inside the fixture, never at import)."""

from __future__ import annotations

import pytest
import torch

from slam_bench import manifest

# orb_tum640 at half size: the harness end to end on the CPU in seconds
SMALL_ORB = {"image_width": 320, "image_height": 240, "Camera.fx": 258.653204,
             "Camera.fy": 258.234608, "Camera.cx": 159.32152, "Camera.cy": 127.656995,
             "ORBextractor.nFeatures": 400}
SMALL_TRAFFIC = {"setup_frames": 30, "sample_every": 1, "b1_sample_every": 2}


def small(cell: dict, **traffic) -> dict:
    """Overrides that run `cell` at the CPU tests' sizes."""
    config = {} if cell["config"].startswith("loftr") else dict(SMALL_ORB)
    # a short CPU window compares fewer answers than the cell's floors ask
    limits = {k: {"min": 1} for k in manifest.load_json(manifest.limits_file(cell["name"]))
              if k.endswith("_checked")}
    return {"config": config, "traffic": {**SMALL_TRAFFIC, **traffic}, "limits": limits}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
