"""Port parity for the multi-device serving and sweep entry points
(mono_slam_framework_torch/parallel: multistream.py's sharded steady steps,
sweep.py's ORB matcher sweep and tracking step, ab_sweep's
`--sharded-loftr`), on CPU meshes of `["cpu"] * n` (the JAX tests' virtual
CPU devices, conftest).

Each sharded form is held to the port's own one-device form on the same
inputs, at tests/test_multistream_sharded.py's and tests/test_parallel.py's
shapes:

  * `steady_step_batch_sharded` (8 streams of 120x160, 200 features, a mesh
    of 4) against `steady_step_batch`: every integer output equal, floats
    within 1e-4; an uneven batch raises ValueError;
  * `steady_step_loftr_batch_sharded` (4 streams at the model's 480x640, a
    mesh of 2) against `steady_step_loftr_batch`: f_cur within 2e-3 and at
    least 0.99 of the output entries within 1e-3
    (test_multistream_sharded.py's tolerances);
  * `sharded_matcher_sweep` (16 pairs of 64x96, 64 features, a mesh of 8)
    against `_pair_step` per pair, and `sharded_tracking_step` against
    `pose_optimize` per problem: equal;
  * `ab_sweep.main(--sharded-loftr --device cpu)` over
    test_torch_apps.py's 16-frame TUM sequence, with a mesh of 4 handed in
    (15 pairs padded to 16): the JAX harness's keys, and each pair's count
    equal to per-pair matching.

The one-device forms are held to the JAX package in
tests/test_torch_multistream.py, test_torch_orb.py and
test_torch_matcher.py. The JAX sharded ORB programs are not compiled here:
they cost 89 s, 45 s and 44 s on this CPU under `-n 6` (the `--durations`
of test_multistream_sharded.py and of
test_parallel.py::test_matcher_sweep_over_mesh).
"""

import json

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch to one thread)
import chip_smoke
from test_torch_apps import mini_tum  # noqa: F401  (fixture)
from test_torch_multistream import (
    MAXF,
    STATICS,
    TABLES,
    _batch_args,
    _features,
    _fields,
    _images,
    _stream_state,
)
import mono_slam_framework_torch.parallel as parallel
from mono_slam_framework_torch import ab_sweep, convert
from mono_slam_framework_torch.matchers.loftr_matcher import to_model
from mono_slam_framework_torch.models import loftr_native as pln
from mono_slam_framework_torch.ops import orb
from mono_slam_framework_torch.optim import pose_opt
from mono_slam_framework_torch.parallel import multistream, sweep


def cpu_mesh(n):
    return parallel.make_mesh(devices=["cpu"] * n)


def _orb_args(n):
    """n streams' steady-step arguments; each stream's current frame is its
    own previous frame (test_torch_multistream.py's self-match)."""
    imgs = torch.from_numpy(_images(n, seed=3))
    feats = multistream.extract_batch(imgs, MAXF)
    states = [_stream_state(convert.features_to_numpy(_features(feats, i)), 30 + i, **TABLES)
              for i in range(n)]
    return (imgs,) + _batch_args(states)


def test_steady_step_batch_sharded_matches_one_device():
    args = _orb_args(8)
    statics = dict(**STATICS, max_features=MAXF, fast_threshold=20.0)
    ref = multistream.steady_step_batch(*args, **statics)
    got = parallel.steady_step_batch_sharded(cpu_mesh(4), *args, **statics)
    for name, a in _fields(got).items():
        b = _fields(ref)[name]
        if a.is_floating_point():
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4, err_msg=name)
        else:
            assert torch.equal(a, b), name
    for name, a, b in zip(orb.Features._fields, got.cur, ref.cur):
        assert torch.equal(a, b), name
    assert int((got.union_row >= 0).sum()) >= 8 * 20
    with pytest.raises(ValueError, match="does not divide"):
        parallel.steady_step_batch_sharded(cpu_mesh(4), *_orb_args(2), **statics)


def test_steady_step_loftr_batch_sharded_matches_one_device():
    model = pln.load_model(device="cpu")
    n = 4
    rng = np.random.default_rng(11)
    imgs = torch.from_numpy(np.stack([
        np.kron(rng.uniform(0, 255, (60, 80)).astype(np.float32), np.ones((8, 8), np.float32))
        for _ in range(n)]))
    pos = chip_smoke.loftr_batch_inputs(pln.encode(model, to_model(imgs)))
    statics = dict(threshold=0.1, width=640.0, height=480.0, resize_hw=None)
    ref = multistream.steady_step_loftr_batch(imgs, model, *pos, **statics)
    got = parallel.steady_step_loftr_batch_sharded(cpu_mesh(2), imgs, model, *pos, **statics)
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=2e-3, atol=2e-3)

    def flat(out):
        f_cur, lo, union_row, T2 = out
        return np.concatenate([x.reshape(-1).numpy().astype(np.float64)
                               for x in (*lo, union_row, T2)])

    a, b = flat(got), flat(ref)
    assert a.shape == b.shape
    assert np.isclose(a, b, rtol=1e-3, atol=1e-3).mean() > 0.99
    assert int((ref[1].row >= 0).sum()) >= n * 100  # the motion phase associated cells


def test_sharded_matcher_sweep_and_tracking_step_match_per_pair():
    rng = np.random.default_rng(0)
    B, H, W = 16, 64, 96
    base = np.kron(rng.uniform(0, 255, (H // 8, W // 8)), np.ones((8, 8)))
    imgs1 = torch.from_numpy(np.stack([np.roll(base, i, 1) for i in range(B)]).astype(np.float32))
    imgs2 = torch.from_numpy(np.stack([np.roll(base, i + 3, 1) for i in range(B)])
                             .astype(np.float32))
    mesh = cpu_mesh(8)
    xy1, xy2, ok = parallel.sharded_matcher_sweep(mesh, imgs1, imgs2, max_features=64)
    assert xy1.shape == (B, 64, 2) and ok.shape == (B, 64)
    singles = [sweep._pair_step(imgs1[i], imgs2[i], 64, 0.7) for i in range(B)]
    for i, (a1, a2, aok) in enumerate(singles):
        assert torch.equal(xy1[i], a1) and torch.equal(xy2[i], a2), i
        assert torch.equal(ok[i], aok), i
    assert (ok.sum(1) > 0).float().mean() > 0.8
    with pytest.raises(ValueError):
        parallel.sharded_matcher_sweep(cpu_mesh(3), imgs1, imgs2, max_features=64)

    # the tracking step: the same pairs' matching and one pose LM per pair
    nb = 8
    probs = [chip_smoke.pose_problem(seed=s, n=200, n_outliers=10, n_pad=8) for s in range(nb)]
    T0, X, uv, valid, K, _ = (np.stack(x) for x in zip(*probs))
    t = [torch.from_numpy(a) for a in (T0, X, uv, valid)]
    K1 = torch.from_numpy(K[0])
    T_opt, n_inl, n_match = parallel.sharded_tracking_step(
        cpu_mesh(4), imgs1[:nb], imgs2[:nb], *t, K1, max_features=64)
    assert T_opt.shape == (nb, 4, 4) and n_inl.dtype == torch.int32
    for i in range(nb):
        T_ref, _, n_ref = pose_opt.pose_optimize(*(x[i] for x in t), K1)
        assert torch.equal(T_opt[i], T_ref), i
        assert int(n_inl[i]) == int(n_ref) > 150, i
        assert int(n_match[i]) == int(singles[i][2].sum()), i


def test_ab_sweep_sharded_loftr(mini_tum, capsys, monkeypatch):  # noqa: F811
    root, world = mini_tum
    mesh = cpu_mesh(4)
    monkeypatch.setattr(parallel, "make_mesh", lambda *a, **k: mesh)
    seen = []
    real = parallel.sharded_loftr_sweep

    def spy(mesh, model, f1, f2, max_matches):
        out = real(mesh, model, f1, f2, max_matches)
        seen.append(out[0])
        return out

    monkeypatch.setattr(parallel, "sharded_loftr_sweep", spy)
    results = ab_sweep.main([
        "--dataset", "tum", "--path", root, "--matchers", "", "--sharded-loftr",
        "--fx", str(world.f), "--fy", str(world.f), "--cx", str(world.cx),
        "--cy", str(world.cy), "--device", "cpu"])
    rec = results[-1]
    printed = json.loads(capsys.readouterr().out)["sweep"][-1]
    # the JAX harness's keys (mono_slam_framework_tpu/ab_sweep.py:120-127)
    assert set(rec) == {"matcher", "devices", "pairs", "pairs_per_s", "mean_matches",
                        "min_matches"} == set(printed)
    assert rec["matcher"] == "loftr-sharded" and rec["devices"] == 4
    assert rec["pairs"] == 15 and seen[0].shape == (16, 256)  # padded to a mesh multiple
    # each pair's count against per-pair matching on the same encoded frames
    from mono_slam_framework_torch.io.datasets import LOADERS

    model = pln.load_model(device="cpu")
    feats = [pln.encode(model, to_model(torch.from_numpy(np.asarray(fr.image, np.float32))))
             for fr in LOADERS["tum"](root)]
    counts = [int((pln.match_features_topk(model, feats[i], feats[i + 1], 256)[0] > 0.1).sum())
              for i in range(15)]
    got = (seen[0] > 0.1).sum(1)[:15].tolist()
    assert got == counts
    assert rec["mean_matches"] == round(float(np.mean(counts)), 1)
    assert rec["min_matches"] == min(counts) > 0
