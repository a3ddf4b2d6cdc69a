"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy and handed to both the JAX function and its
port; results come back as numpy and are compared with stated tolerances.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

torch.set_num_threads(1)
# chip_smoke.py (repo root) holds the kernel-vs-plain checks the cuda tests run
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def t32(x, dtype=np.float32):
    """numpy -> CPU torch tensor of the given numpy dtype (a writable copy)."""
    return torch.from_numpy(np.array(x, dtype=dtype))


def interior(shape, border=31):
    m = np.zeros(shape, bool)
    m[border : shape[0] - border, border : shape[1] - border] = True
    return m


def jax_features_np(f) -> dict:
    """JAX Features -> dict of numpy arrays (desc stays uint32 words)."""
    return {k: np.asarray(v) for k, v in f._asdict().items()}


def compare_feature_sets(fa: dict, fb: dict):
    """Feature sets agree as tests/test_pallas_detect.py:114-165 requires:
    >= 95 % of keypoints in common, >= 90 % of the common descriptors
    bit-identical, no common pair more than 16 bits apart."""
    import chip_smoke

    share, same, worst = chip_smoke.feature_set_agreement(fa, fb)
    assert share >= 0.95, share
    assert same >= 0.9, same
    assert worst <= 16, worst


def require_cuda():
    """Skip the calling test unless a CUDA card is present (decided at run
    time, never at import or collection)."""
    import pytest

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; runs on the H100 (python3 chip_smoke.py)")
