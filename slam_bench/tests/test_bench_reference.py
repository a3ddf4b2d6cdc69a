"""The plain references agree with the program at small sizes on the CPU,
and their lower-precision controls do not (the test may import both; the
references import nothing of the program)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mono_slam_framework_torch.models import loftr_native
from mono_slam_framework_torch.ops import detect
from mono_slam_framework_torch.io import trajectory
from mono_slam_framework_torch.ops import hamming
from mono_slam_framework_torch.optim import pose_opt
from mono_slam_framework_torch import sim
from slam_bench.reference import detect as ref_detect
from slam_bench.reference import hamming as ref_hamming
from slam_bench.reference import ate as ref_ate
from slam_bench.reference import loftr as ref_loftr
from slam_bench.reference import pose_lm as ref_pose
from slam_bench.reference.precision import round_operand

WEIGHTS = loftr_native.WEIGHTS_PATH


def _pose_problems(b=3, n=300, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 10, n)], -1)
        xi = rng.normal(size=6) * 0.1
        T = ref_pose.exp_se3(torch.tensor(xi, dtype=torch.float32)[None], "f32")[0].numpy()
        Xc = X @ T[:3, :3].T + T[:3, 3]
        uv = Xc[:, :2] / Xc[:, 2:] * 500 + np.array([320.0, 240.0]) + rng.normal(0, 0.8, (n, 2))
        uv[:20] += 60.0
        T0 = ref_pose.exp_se3(torch.tensor(xi + rng.normal(size=6) * 0.03, dtype=torch.float32)[None],
                              "f32")[0].numpy()
        valid = rng.random(n) < 0.9
        K = np.array([[500, 0, 320], [0, 500, 240], [0, 0, 1]])
        out.append((T0, X, uv, valid, K, rng.uniform(0.5, 1.5, n)))
    cols = list(zip(*out))
    f = lambda a: torch.tensor(np.stack(a), dtype=torch.float32)  # noqa: E731
    return f(cols[0]), f(cols[1]), f(cols[2]), torch.tensor(np.stack(cols[3])), f(cols[4]), f(cols[5])


def test_pose_lm_matches_the_program():
    args = _pose_problems()
    T_p, in_p, n_p = pose_opt.pose_lm_batched_plain(*args)
    T_r, in_r, n_r = ref_pose.pose_lm(*args)
    assert float((T_p - T_r).abs().max()) < 1e-4
    assert torch.equal(in_p, in_r) and torch.equal(n_p, n_r.to(n_p.dtype))


def test_pose_lm_control_departs():
    args = _pose_problems()
    T_r = ref_pose.pose_lm(*args)[0]
    T_c = ref_pose.pose_lm(*args, mode="tf32")[0]
    assert float((T_c - T_r).abs().max()) > 1e-4


def test_detection_maps_match_the_program():
    world = sim.PlaneWorld(width=160, height=120, f=128.0, second_plane=(3.0, 0.3), tex_size=512)
    img = torch.from_numpy(world.render(sim.lateral_trajectory(1)[0]))
    dims = ((120, 160), (100, 133), (83, 111))
    _, rows, w0 = detect.level_layout(dims)
    stack = torch.zeros(rows, w0)
    r = 0
    for h, w in dims:
        stack[r : r + h, :w] = torch.nn.functional.interpolate(img[None, None], size=(h, w),
                                                               mode="bilinear")[0, 0]
        r += h
    prog = detect.detect_maps_plain(stack, dims, 20.0, 8)
    ref = ref_detect.detect_maps(stack, dims, 20.0, 8)
    for p, q in zip(prog, ref):
        assert torch.equal(torch.isfinite(p), torch.isfinite(q))
        both = torch.isfinite(q)
        assert float((p[both] - q[both]).abs().max()) <= 1e-5 * float(q[both].abs().max())
    low = ref_detect.detect_maps(stack, dims, 20.0, 8, mode="tf32")
    assert float((low[4] - ref[4]).abs().max()) > 1e-5 * float(ref[4].abs().max())


def test_loftr_confidence_matches_the_program():
    rng = np.random.default_rng(0)
    world = sim.PlaneWorld(width=640, height=480, f=500.0, second_plane=(3.0, 0.3), seed=int(rng.integers(99)))
    a, b = (world.render(T) for T in sim.lateral_trajectory(2, step=0.02))
    model = loftr_native.load_model(WEIGHTS, "cpu")
    to = lambda x: torch.from_numpy(x)[None, None] / 255.0  # noqa: E731
    prog = loftr_native.loftr_confidence(model, to(a), to(b))[0]
    p = ref_loftr.load_weights(WEIGHTS, torch.device("cpu"))
    ref = ref_loftr.confidence(p, torch.from_numpy(a), torch.from_numpy(b))
    assert float((prog - ref).abs().max()) < 1e-5
    low = ref_loftr.confidence(p, torch.from_numpy(a), torch.from_numpy(b), "fp8")
    assert float((low - ref).abs().max()) > 1e-2


@pytest.mark.parametrize("mode,bits", [("tf32", 10), ("fp8", 3)])
def test_rounding_keeps_the_stated_mantissa(mode, bits):
    x = torch.tensor([1.0 + 2.0 ** -(bits + 2), 3.0, -0.7])
    r = round_operand(x, mode)
    assert float(r[1]) == 3.0 and abs(float(r[0]) - 1.0) < 2.0 ** -bits
    assert float((r - x).abs().max()) <= 2.0 ** -(bits) * float(x.abs().max())


def test_hamming_matches_the_program():
    """The popcount reference against the program's bf16 matmul, exactly,
    one set against a batch of sets, invalid pairs included."""
    rng = np.random.default_rng(1)
    d1 = torch.tensor(rng.integers(-2**31, 2**31, (64, 8)), dtype=torch.int32)
    d2 = torch.tensor(rng.integers(-2**31, 2**31, (3, 50, 8)), dtype=torch.int32)
    d2[1, :10] = d1[:10]  # identical descriptors: distance 0
    v1, v2 = torch.tensor(rng.random(64) < 0.9), torch.tensor(rng.random((3, 50)) < 0.9)
    ref = ref_hamming.distance_matrix(d1, d2, v1, v2)
    assert torch.equal(hamming.distance_matrix(d1, d2, v1, v2), ref)
    assert float(ref[1, :10, :10].diagonal()[v1[:10] & v2[1, :10]].max()) == 0.0


def test_ate_matches_the_program():
    """The frozen alignment against io/trajectory.ate_rmse on a scaled,
    rotated and noisy copy of a sweep."""
    rng = np.random.default_rng(2)
    x = 1.0 - np.cos(2 * np.pi * np.arange(120) / 240)
    gt = np.tile(np.eye(4), (120, 1, 1))
    gt[:, 0, 3], gt[:, 1, 3] = -x, -0.015 * (np.arange(120) % 3)
    c = ref_ate.centres(gt)
    np.testing.assert_allclose(c[:, 0], x)
    R = ref_pose.exp_se3(torch.tensor([[0.1, -0.2, 0.3, 0, 0, 0]], dtype=torch.float64), "f32")[0, :3, :3].numpy()
    est_c = 0.37 * c @ R.T + [0.5, -1.0, 2.0] + rng.normal(0, 0.003, c.shape)
    est = np.tile(np.eye(4), (120, 1, 1))
    est[:, :3, :3] = R.T[None]
    est[:, :3, 3] = -np.einsum("ij,nj->ni", R.T, est_c)
    want, _ = trajectory.ate_rmse(np.arange(120.0), est_c, np.arange(120.0), c)
    got = ref_ate.ate_rmse(est, gt)
    # the noise, 0.003 an axis in the estimate, is 0.003 / 0.37 an axis after alignment
    assert abs(got - want) < 1e-9 and 0.01 < got < 0.02
