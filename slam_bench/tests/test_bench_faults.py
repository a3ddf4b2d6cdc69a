"""The harness's comparison, driven end to end on the CPU at a small size
(the look for a card skipped), comes out true on the program as it is and
false with the timed path broken underneath: a step that returns its state
unchanged, and an answer altered where it is produced (the pose LM, the
detection maps, the Hamming distances, the LoFTR confidence, the map points
triangulated from set-up on). No cell serves a batch or runs across chips,
so half a batch left out and the exchange between chips have no fault here."""

from __future__ import annotations

import contextlib

import pytest
import torch

from mono_slam_framework_torch.geometry import triangulation
from mono_slam_framework_torch.models import loftr_native
from mono_slam_framework_torch.ops import detect, hamming
from mono_slam_framework_torch.optim import pose_opt
from slam_bench import harness, manifest

from .conftest import small

CPU = torch.device("cpu")
BENCH = manifest.load_manifest()


def _run(cell, fault=None, seconds=2.0, **traffic):
    w = manifest.workload(BENCH, cell)
    return harness.run_cell(w, 20260417, seconds, False, CPU, BENCH,
                            overrides=small(w, **traffic), fault=fault)


@contextlib.contextmanager
def _patched(owner, name, make):
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def state_unchanged(driver):
    """Every System's frame call returns at once: the tracker keeps its
    last frame and state."""
    stack = contextlib.ExitStack()
    for s in driver.systems:
        stack.enter_context(_patched(s, "track_monocular", lambda real: lambda image, timestamp: None))
    return stack


def pose_altered(driver):
    """Every pose LM's pose moved by 1e-3 inside the solver (its plain
    version on the CPU, under the harness's hooks)."""
    def make(real):
        def wrapped(*a, **k):
            T, inlier, n_good = real(*a, **k)
            return T + 1e-3 * torch.ones_like(T), inlier, n_good
        return wrapped
    stack = contextlib.ExitStack()
    stack.enter_context(_patched(pose_opt, "pose_optimize_plain", make))
    stack.enter_context(_patched(pose_opt, "pose_lm_batched_plain", make))
    return stack


def maps_altered(driver):
    """The detection's blur map scaled by 1.01 inside detection (its plain
    version on the CPU, under the harness's hooks)."""
    def make(real):
        def wrapped(stack, dims, threshold=20.0, border=31):
            m = real(stack, dims, threshold, border)
            return m._replace(blur=m.blur * 1.01)
        return wrapped
    return _patched(detect, "detect_maps_plain", make)


def confidence_altered(driver):
    """The second image's transformed features shifted by one cell inside
    the model's forward (under the harness's hooks): every confidence is
    the answer for a neighbouring cell."""
    def make(real):
        def wrapped(model, f0, f1):
            a, b = real(model, f0, f1)
            return a, b.roll(1, dims=1)
        return wrapped
    return _patched(loftr_native, "coarse_transformer", make)


def distances_altered(driver):
    """The first bit of every 4th descriptor flipped inside the distance
    computation (under the harness's hooks): a quarter of the distances
    are one off."""
    def make(real):
        def wrapped(packed, dtype=torch.float32):
            bits = real(packed, dtype).clone()
            bits[..., ::4, 0] = 1 - bits[..., ::4, 0]
            return bits
        return wrapped
    return _patched(hamming, "unpack_bits", make)


@contextlib.contextmanager
def map_points_moved(sigma: float):
    """Every point local mapping triangulates moved by N(0, sigma) world
    units, from set-up on (the map the window tracks against is wrong)."""
    g = torch.Generator().manual_seed(0)

    def make(real):
        def wrapped(*a, **k):
            X, ok = real(*a, **k)
            return X + sigma * torch.randn(X.shape, generator=g).to(X.device), ok
        return wrapped
    with _patched(triangulation, "triangulate_gated_many", make):
        yield


def test_sound_run_is_correct():
    out = _run("orb.sweep")
    assert out.result["correct"], out.result["checks"]


@pytest.mark.parametrize("fault,number", [
    (state_unchanged, "pose_unmatched"),
    (pose_altered, "pose_px"),
    (maps_altered, "b1_gap"),
    (distances_altered, "ham_wrong"),
])
def test_fault_is_caught(fault, number):
    out = _run("orb.sweep", fault)
    assert not out.result["correct"]
    assert not harness.compare.within(out.numbers[number], out.limits[number])


def test_wrong_map_is_caught():
    """Map points 0.1 world units off (the scene lies 3-5 units away) lose
    the track: frames_lost."""
    with map_points_moved(0.1):
        out = _run("orb.sweep")
    assert not out.result["correct"]
    assert out.numbers["frames_lost"] > 0


def test_loftr_sound_and_altered_confidence():
    sound = _run("loftr.sweep", seconds=3.0, setup_frames=40, sample_every=2)
    assert sound.result["correct"], sound.result["checks"]
    bad = _run("loftr.sweep", confidence_altered, seconds=3.0, setup_frames=40, sample_every=2)
    assert not bad.result["correct"]
    assert bad.numbers["conf_gap"] > bad.limits["conf_gap"]["max"]
