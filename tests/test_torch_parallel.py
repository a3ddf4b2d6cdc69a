"""Port parity for the multi-device layer (mono_slam_framework_torch/parallel:
mesh.py, loftr_tp.py, sweep.py's LoFTR sweep, ba_sharded.py and the
loop-GBA route of slam/device_io.py), at tests/test_parallel.py's and
tests/test_gba_sharded_pipeline.py's sizes.

The port drives a mesh from one process; on the CPU a mesh of
`["cpu"] * 8` stands for the JAX tests' 8 virtual CPU devices (conftest).

  * the mesh helpers (`split`, `gather`, `psum`, `pmax`, `all_gather`)
    against the unsharded ops; an uneven axis raises ValueError; without a
    card `make_mesh()` / `make_ba_mesh()` raise;
  * `loftr_tp_confidence` against the JAX `loftr_tp_confidence` on
    `make_mesh(8)` and against the port's single-device confidence (same
    weights, seeded f0 / f1 [1, 1200, 32]): < 1e-5;
  * `sharded_loftr_sweep` (B = 8, top 16) against the JAX one (idx equal,
    vals within 1e-5) and against the port's `match_features_topk` per
    pair (1e-6);
  * `global_bundle_adjust_sharded` against the JAX one (test_parallel.py's
    problem and tolerances); a one-shard mesh equals the port's
    `global_bundle_adjust` bit for bit;
  * the loop-GBA route (`LoopClosing.run_global_bundle_adjustment`) on
    test_gba_sharded_pipeline.py's 28-keyframe map, with the mesh handed to
    `device_io.global_ba_mesh` (the JAX test gets its mesh from the
    8-device conftest): the sharded solver ran, the staged markers and the
    propagation were applied, the poses are within 5e-3 of the port's
    one-device route and of the JAX package's sharded route, both packages
    on the reference's schedule (`loopFuseDuplicates=False`).

The `cuda` tests run chip_smoke's per-card checks of the `mesh` phase (B1
and B2 launched on every distinct card of the mesh, the collectives on the
card) and skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch to one thread)
from torch_parity import require_cuda
from test_optim import K as BA_K
from test_optim import make_ba_problem
import mono_slam_framework_tpu.parallel as jparallel
from mono_slam_framework_tpu.models import loftr_native as jln
from mono_slam_framework_tpu.optim.bundle_adjust import build_problem as jbuild_problem
from mono_slam_framework_tpu.params import SlamParameters as JParams
from mono_slam_framework_tpu.slam import frame as jframe
from mono_slam_framework_tpu.slam import loop_closing as jlc
from mono_slam_framework_tpu.slam import map_model as jmm
import mono_slam_framework_torch.parallel as parallel
from mono_slam_framework_torch.models import loftr_native as pln
from mono_slam_framework_torch.optim import bundle_adjust as pba
from mono_slam_framework_torch.params import SlamParameters
from mono_slam_framework_torch.parallel import ba_sharded, mesh as mesh_mod
from mono_slam_framework_torch.slam import device_io
from mono_slam_framework_torch.slam import frame as pframe
from mono_slam_framework_torch.slam import loop_closing as plc
from mono_slam_framework_torch.slam import map_model as pmm


def cpu_mesh(n, axis="data"):
    return parallel.make_mesh(devices=["cpu"] * n, axis=axis)


# ---------------------------------------------------------------------------
# the mesh


def test_mesh_helpers_match_unsharded_ops():
    rng = np.random.default_rng(0)
    m = cpu_mesh(4)
    x = torch.from_numpy(rng.normal(size=(8, 6, 3)).astype(np.float32))
    parts = m.split(x)
    assert m.size == 4 and [p.shape for p in parts] == [(2, 6, 3)] * 4
    assert torch.equal(m.gather(parts), x)
    m3 = cpu_mesh(3)
    assert [p.shape for p in m3.split(x, dim=1)] == [(8, 2, 3)] * 3
    assert torch.equal(m3.gather(m3.split(x, dim=1), dim=1), x)
    # collectives over per-shard partials: every shard gets the full result
    for got in m.psum(parts):
        np.testing.assert_allclose(got.numpy(), sum(p for p in parts).numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(m.psum(parts)[0].numpy(), x.reshape(4, 2, 6, 3).sum(0).numpy(),
                               atol=1e-6)
    for got in m.pmax(parts):
        assert torch.equal(got, x.reshape(4, 2, 6, 3).amax(0))
    for got in m.all_gather(parts, dim=0):
        assert torch.equal(got, x)
    # NamedTuples split and gather field by field
    f = pba.BAProblem(*([x] * 12))
    fp = m.split(f)
    assert type(fp[0]) is pba.BAProblem and torch.equal(m.gather(fp).points, x)
    # an axis the mesh does not divide
    with pytest.raises(ValueError, match="does not divide"):
        cpu_mesh(3).split(x)
    # repeats are one device: broadcast and replicate make no copies
    assert all(b is x for b in m.broadcast(x))
    model = torch.nn.Linear(2, 2)
    assert all(r is model for r in m.replicate(model))


def test_mesh_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.make_ba_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.make_mesh(devices=["cuda:0"] * 4)
    assert parallel.make_mesh(2, devices=["cpu"] * 8).size == 2
    # the loop GBA's decision: no mesh for a CPU System or a single card
    assert device_io.global_ba_mesh("cpu") is None
    assert device_io.global_ba_mesh(torch.device("cpu")) is None


def test_global_ba_mesh_takes_every_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert device_io.global_ba_mesh("cuda") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(parallel, "make_ba_mesh", lambda: "edge mesh")
    assert device_io.global_ba_mesh("cuda:0") == "edge mesh"


# ---------------------------------------------------------------------------
# LoFTR: tensor-parallel confidence and the data-parallel sweep


@pytest.fixture(scope="module")
def loftr_weights():
    return jln.load_params(), pln.load_model(device="cpu")


def test_loftr_tp_matches_jax_and_single_device(loftr_weights):
    params, model = loftr_weights
    rng = np.random.default_rng(1)
    f0 = rng.normal(size=(1, 1200, 32)).astype(np.float32)
    f1 = rng.normal(size=(1, 1200, 32)).astype(np.float32)
    ref = np.asarray(jparallel.loftr_tp_confidence(
        jparallel.make_mesh(8), params, jnp.asarray(f0), jnp.asarray(f1)))
    got = parallel.loftr_tp_confidence(cpu_mesh(8), model, torch.from_numpy(f0),
                                       torch.from_numpy(f1)).numpy()
    single = pln.confidence_from_features(model, torch.from_numpy(f0),
                                          torch.from_numpy(f1)).numpy()
    assert got.shape == (1, 1200, 1200)
    assert np.abs(got - ref).max() < 1e-5
    assert np.abs(got - single).max() < 1e-5
    # the tokens do not divide over 7 shards
    with pytest.raises(ValueError):
        parallel.loftr_tp_confidence(cpu_mesh(7), model, torch.from_numpy(f0),
                                     torch.from_numpy(f1))


def test_sharded_loftr_sweep_matches_jax_and_per_pair(loftr_weights):
    _, model = loftr_weights
    rng = np.random.default_rng(2)
    B = 8
    f1 = rng.normal(size=(B, 1200, 32)).astype(np.float32)
    f2 = rng.normal(size=(B, 1200, 32)).astype(np.float32)
    jv, ji = jparallel.sharded_loftr_sweep(jparallel.make_mesh(8), jnp.asarray(f1),
                                           jnp.asarray(f2), max_matches=16)
    vals, idx = parallel.sharded_loftr_sweep(cpu_mesh(8), model, torch.from_numpy(f1),
                                             torch.from_numpy(f2), max_matches=16)
    assert vals.shape == (B, 16) and idx.shape == (B, 16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    for i in range(B):
        rv, ri = pln.match_features_topk(model, torch.from_numpy(f1[i: i + 1]),
                                         torch.from_numpy(f2[i: i + 1]), 16)
        np.testing.assert_allclose(vals[i].numpy(), rv[0].numpy(), rtol=0, atol=1e-6)
        assert torch.equal(idx[i], ri[0]), i


# ---------------------------------------------------------------------------
# edge-sharded global BA


def _ba_inputs():
    rng = np.random.default_rng(11)
    cams_true, cams0, fixed, X, X0, e_cam, e_pt, e_uv = make_ba_problem(rng, n_cams=6, n_pts=120)
    return cams_true, fixed, (np.stack(cams0).astype(np.float32), fixed, X0.astype(np.float32),
                              e_cam, e_pt, e_uv.astype(np.float32), BA_K)


def test_global_ba_sharded_matches_jax_and_one_shard():
    cams_true, fixed, args = _ba_inputs()
    jp = jbuild_problem(*args, with_pairs=False)
    JT, JX, Jchi = (np.asarray(a) for a in jparallel.global_bundle_adjust_sharded(
        jparallel.make_ba_mesh(), jp, n_iters=8, cg_iters=40))
    p = pba.build_problem(*args, with_pairs=False, device="cpu")
    E = p.e_cam.shape[0]
    assert E % 8 != 0  # the padding to a mesh multiple is exercised
    T, X, chi = parallel.global_bundle_adjust_sharded(
        cpu_mesh(8, ba_sharded.AXIS), p, n_iters=8, cg_iters=40)
    assert np.allclose(chi.numpy(), Jchi, rtol=1e-3)
    assert np.abs(T.numpy() - JT).max() < 1e-3
    assert np.abs(X.numpy() - JX).max() < 1e-2
    for c in range(len(cams_true)):
        if not fixed[c]:
            assert np.abs(T.numpy()[c] - cams_true[c]).max() < 0.05
    # one shard: the single-device solver, bit for bit
    ref = pba.global_bundle_adjust(p, n_iters=8, cg_iters=40)
    one = parallel.global_bundle_adjust_sharded(cpu_mesh(1, ba_sharded.AXIS), p,
                                                n_iters=8, cg_iters=40)
    for a, b in zip(one, ref):
        assert torch.equal(a, b)
    padded = ba_sharded._pad_edges(p, 8)
    assert padded.e_cam.shape[0] % 8 == 0
    assert not padded.e_valid[E:].any() and bool((padded.e_info[E:] == 1.0).all())


# ---------------------------------------------------------------------------
# the loop-GBA route on test_gba_sharded_pipeline.py's map

N_KF = 28  # > GLOBAL_BA_DENSE_MAX_CAMS (24): the PCG / sharded route
N_PT = 240
IMG_W, IMG_H = 64, 48
K_GBA = np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1]], np.float32)
# the reference's loop-GBA schedule (10 LM iterations, CG 60) in both
# packages: the fused-duplicates schedule (25 x CG 200) runs the same route
# eight times longer on this CPU
GBA_SCHEDULE = dict(loopFuseDuplicates=False)


def _build_map(pkg, seed=0):
    """test_gba_sharded_pipeline.py's map, with either package's classes
    (`pkg` = (frame module, map_model module))."""
    frame_mod, mm = pkg
    frame_mod.reset_frame_ids()
    mm.reset_map_ids()
    rng = np.random.default_rng(seed)
    m = mm.Map()
    pts_gt = np.stack([rng.uniform(-3, 6, N_PT), rng.uniform(-2, 2, N_PT),
                       rng.uniform(5, 8, N_PT)], axis=-1).astype(np.float32)
    img = np.zeros((IMG_H, IMG_W), np.float32)
    kfs = []
    for i in range(N_KF):
        T_gt = np.eye(4, dtype=np.float32)
        T_gt[:3, 3] = [-0.12 * i, 0.01 * (i % 3), 0.0]
        frame = frame_mod.Frame(img, timestamp=i * 0.1, K=K_GBA)
        T_init = T_gt.copy()
        if i > 0:  # KF0 is the fixed gauge anchor
            T_init[:3, 3] += rng.normal(0, 0.02, 3).astype(np.float32)
        frame.set_pose(T_init)
        kf = mm.KeyFrame(frame, m, kf_db=None)
        kf.T_gt = T_gt
        m.add_keyframe(kf)
        kfs.append(kf)
        if i > 0:
            kf.parent = kfs[i - 1]
            kfs[i - 1].children.add(kf)
    m.keyframe_origins.append(kfs[0])
    for j in range(N_PT):
        X = pts_gt[j]
        mp = mm.MapPoint(X + rng.normal(0, 0.03, 3).astype(np.float32), kfs[0], m)
        n_obs = 0
        for kf in kfs:
            Xc = kf.T_gt[:3, :3] @ X + kf.T_gt[:3, 3]
            if Xc[2] <= 0.1:
                continue
            u = K_GBA[0, 0] * Xc[0] / Xc[2] + K_GBA[0, 2]
            v = K_GBA[1, 1] * Xc[1] / Xc[2] + K_GBA[1, 2]
            if not (0 <= u < IMG_W and 0 <= v < IMG_H):
                continue
            uv = (float(u + rng.normal(0, 0.3)), float(v + rng.normal(0, 0.3)))
            mp.add_observation(kf, (int(uv[0]), int(uv[1])), measurement=uv)
            n_obs += 1
        if n_obs >= 3:
            m.add_map_point(mp)
    return m, kfs


def _port_gba(mesh):
    """The port's loop GBA on a fresh map, with `mesh` handed to the route
    (None: the one-device solver). Returns the keyframes and the sharded
    solver's calls (camera counts)."""
    calls = []
    real = parallel.global_bundle_adjust_sharded

    def spy(mesh, p, **kw):
        calls.append(p.cam_T.shape[0])
        return real(mesh, p, **kw)

    m, kfs = _build_map((pframe, pmm))
    params = SlamParameters(fx=60.0, fy=60.0, cx=32.0, cy=24.0, **GBA_SCHEDULE)
    lc = plc.LoopClosing(m, None, None, params, device="cpu", verbose=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(device_io, "global_ba_mesh", lambda device: mesh)
        mp.setattr(parallel, "global_bundle_adjust_sharded", spy)
        lc.run_global_bundle_adjustment(kfs[-1].id)
    return m, kfs, calls


def test_loop_gba_routes_through_the_mesh():
    m_a, kfs_a, calls = _port_gba(cpu_mesh(8, ba_sharded.AXIS))
    loop_kf_id = kfs_a[-1].id
    assert calls and calls[0] >= N_KF, calls
    for kf in kfs_a:
        assert kf.ba_global_for_kf == loop_kf_id
        assert kf.Tcw_bef_gba is not None
        R = kf.get_pose()[:3, :3]
        assert np.abs(R @ R.T - np.eye(3)).max() < 1e-4
    assert m_a.get_last_big_change_idx() > 0
    # the one-device route on the same map
    _, kfs_b, calls_b = _port_gba(None)
    assert not calls_b
    for ka, kb in zip(kfs_a, kfs_b):
        np.testing.assert_allclose(ka.get_pose(), kb.get_pose(), atol=5e-3)
    # the JAX package's sharded route (its 8-device mesh) on the same map
    m_j, kfs_j = _build_map((jframe, jmm))
    jlc.LoopClosing(m_j, None, None, JParams(fx=60.0, fy=60.0, cx=32.0, cy=24.0, **GBA_SCHEDULE),
                    verbose=False).run_global_bundle_adjustment(kfs_j[-1].id)
    for ka, kj in zip(kfs_a, kfs_j):
        np.testing.assert_allclose(ka.get_pose(), kj.get_pose(), atol=5e-3)
    err_before = np.mean([np.linalg.norm(kf.Tcw_bef_gba[:3, 3] - kf.T_gt[:3, 3]) for kf in kfs_a])
    err_after = np.mean([np.linalg.norm(kf.get_pose()[:3, 3] - kf.T_gt[:3, 3]) for kf in kfs_a])
    assert err_after < err_before


# ---------------------------------------------------------------------------
# on the card: chip_smoke's per-card checks of the mesh phase


@pytest.mark.cuda
def test_kernels_launch_on_every_card_of_the_mesh():
    require_cuda()
    import chip_smoke

    chip_smoke.check_mesh_cards(chip_smoke.smoke_mesh())


@pytest.mark.cuda
def test_collectives_on_the_card():
    require_cuda()
    import chip_smoke

    chip_smoke.check_collectives(chip_smoke.smoke_mesh())


def test_parallel_exports_the_jax_names():
    assert mesh_mod.Mesh is parallel.Mesh
    assert set(jparallel.__all__) <= set(parallel.__all__)
