"""Relocalization and loop correction in the port's System, on the CPU.

  * test_reloc_loop.py's three scenarios through the port (its world and its
    400 features, in the default fused flow): relocalization after a
    dropout, the recovered pose within 0.05 of the pre-dropout pose of the
    same view, the next frame on the host path and the one after it on the
    fused flow; the cooldown escape (relocCooldownInlierFloor); the
    deterministic detect-and-correct loop with pre-alignment off (the
    staged-GBA invariants to 1e-6) and on (a drifted revisit: the Sim(3) fit
    and the essential graph run), through chip_smoke's surgical loop, which
    the card runs at 2000 features;
  * parity on twin maps: the port's map after the surgical setup is
    snapshot and rebuilt as a JAX map (convert.map_from_snapshot with the
    JAX classes); then `_prealign_loop` on the same (new, old) point pairs
    gives keyframe poses and point positions within 1e-4 in both,
    `run_global_bundle_adjustment` with `run_global_ba` staging the same
    seeded result gives the same propagation to 1e-6 (no BA compile), and
    `MapPoint.replace` over the pairs moves every keyframe's
    `KeyPointMap.version` as in the JAX package (the fused flow's ctx keys
    on it).
"""

import numpy as np
import pytest
import torch

import chip_smoke
import torch_parity  # noqa: F401  (pins torch to one thread)
from mono_slam_framework_tpu.params import SlamParameters as JParams
from mono_slam_framework_tpu.slam import frame as jframe
from mono_slam_framework_tpu.slam import loop_closing as jlc
from mono_slam_framework_tpu.slam import map_model as jmm
from mono_slam_framework_torch import convert, sim
from mono_slam_framework_torch.matchers import OrbFeatureMatcher
from mono_slam_framework_torch.params import SlamParameters
from mono_slam_framework_torch.slam import KeyFrameMatchDatabase, System, fused_host
from mono_slam_framework_torch.slam import frame as pframe
from mono_slam_framework_torch.slam import loop_closing as plc
from mono_slam_framework_torch.slam import map_model as pmm
from mono_slam_framework_torch.slam.frame import reset_frame_ids
from mono_slam_framework_torch.slam.map_model import reset_map_ids
from mono_slam_framework_torch.slam.tracking import TrackingState

CPU = torch.device("cpu")
MAX_FEATURES = 400  # test_pipeline.build_system's
JAX_CLASSES = (lambda: jmm.Map(use_native_graph=False), jframe.Frame, jmm.KeyFrame,
               jmm.MapPoint)
PORT_CLASSES = (lambda: pmm.Map(use_native_graph=False), pframe.Frame, pmm.KeyFrame,
                pmm.MapPoint)


def _system(world, **overrides):
    """test_pipeline.build_system on the port, on the CPU."""
    reset_frame_ids()
    reset_map_ids()
    params = SlamParameters(fx=world.f, fy=world.f, cx=world.cx, cy=world.cy,
                            max_features=MAX_FEATURES, minIniMatchCount=100,
                            initializerModelFallback=True, **overrides)
    matcher = OrbFeatureMatcher(threshold=0.7, max_features=MAX_FEATURES, device="cpu")
    return System(params, matcher, KeyFrameMatchDatabase(matcher), verbose=False, device="cpu")


def _run(system, world, poses):
    states = []
    for i, T in enumerate(poses):
        system.track_monocular(world.render(T), timestamp=i * 0.1)
        states.append(system.tracker.state)
    return states


def test_relocalize_after_dropout():
    world = sim.PlaneWorld(second_plane=(3.0, 0.3))
    poses = sim.lateral_trajectory(28, step=0.07)
    system = _system(world)
    system.toggle_initialization_allowed()
    system.set_minimum_keyframes(0)
    assert _run(system, world, poses)[-1] == TrackingState.OK
    n_kf = system.map.n_keyframes()
    assert n_kf >= 2
    revisit_pose = system.tracker.current_frame.get_pose().copy()
    for j in range(3):  # sensor dropout: three flat frames -> LOST, no reset
        system.track_monocular(np.full((world.h, world.w), 128.0, np.float32), 3.0 + j * 0.1)
    assert system.tracker.state == TrackingState.LOST
    assert system.tracker.current_frame.get_pose() is None  # cleared on failure
    assert system.map.n_keyframes() == n_kf
    system.track_monocular(world.render(poses[-1]), 4.0)
    assert system.tracker.state == TrackingState.OK
    assert np.abs(system.tracker.current_frame.get_pose() - revisit_pose).max() < 0.05
    assert system.tracker.last_reloc_frame_id == system.tracker.current_frame.id
    # the frame after a relocalization tracks on the host path (the reference
    # keyframe); the fused flow takes over from the second
    stats = fused_host.pipe_stats(system.tracker)
    paths = []
    for j in range(2):
        before = {k: v for k, v in stats.items() if k.startswith("done_")}
        system.track_monocular(world.render(poses[-1]), 4.1 + 0.1 * j)
        assert system.tracker.state == TrackingState.OK
        paths.append({k: v for k, v in stats.items() if k.startswith("done_")} != before)
    assert paths == [False, True]


def test_inlier_floor_lifts_cooldown_gate():
    world = sim.PlaneWorld(second_plane=(3.0, 0.3))
    system = _system(world)
    system.toggle_initialization_allowed()
    assert TrackingState.OK in _run(system, world, sim.lateral_trajectory(14, step=0.07))
    tr = system.tracker
    tr.last_reloc_frame_id = tr.current_frame.id
    tr.max_frames = 3
    while system.map.n_keyframes() <= tr.max_frames:
        tr.max_frames -= 1
    assert tr.max_frames >= 0
    object.__setattr__(system.params, "relocCooldownInlierFloor", 0)
    assert tr.need_new_keyframe() is False  # the reference's hard block
    assert tr.n_matches_inliers > 0
    object.__setattr__(system.params, "relocCooldownInlierFloor", tr.n_matches_inliers + 1000)
    lifted = tr.need_new_keyframe()
    tr.last_reloc_frame_id = -10_000  # no cooldown at all
    assert lifted == tr.need_new_keyframe()


def test_detect_and_correct_loop_prealign_off():
    setup = chip_smoke.surgical_loop_setup(CPU, MAX_FEATURES, prealign=False)
    assert "OK" in setup["states"] and len(setup["kfs"]) >= 3
    rec = chip_smoke.run_surgical_loop(setup)
    assert rec["max_bef_gba_err"] <= 1e-6 and rec["fused"] > 0
    assert rec["prealign_fit"] is None


@pytest.fixture(scope="module")
def drifted():
    """The surgical setup with a drifted revisit and pre-alignment on, the
    snapshot of its map before loop closing, the loop candidate and the
    duplicate pairs the fuse step finds (as map-point ids)."""
    setup = chip_smoke.surgical_loop_setup(CPU, MAX_FEATURES, prealign=True,
                                           drift=chip_smoke.SURGICAL_DRIFT)
    system, kf_new = setup["system"], setup["kf_new"]
    snap = convert.snapshot_map(system.map)
    matched = system.kf_db.detect_loop_candidate(kf_new, system.params.minNumMPMatches)
    assert matched is not None
    targets = [matched] + [kf for kf in matched.get_best_covisibles(10) if not kf.is_bad]
    pairs, seen = [], set()
    for res in system.matcher.match_against_many(kf_new, targets):
        for i in range(res.num_matches):
            a, b = res.get_map_point1(i), res.get_map_point2(i)
            if a is None or b is None or a is b or a.is_bad or b.is_bad or (a.id, b.id) in seen:
                continue
            seen.add((a.id, b.id))
            pairs.append((a.id, b.id))
    assert len(pairs) > 20
    return setup, snap, kf_new.id, matched.id, pairs


def _twins(snap):
    """(port map, keyframes, points), (JAX map, keyframes, points) from one
    snapshot."""
    return (convert.map_from_snapshot(snap, classes=PORT_CLASSES),
            convert.map_from_snapshot(snap, classes=JAX_CLASSES))


def _closers(snap, cur, matched):
    (pm, pk, pp), (jm, jk, jp) = _twins(snap)
    p = plc.LoopClosing(pm, None, None, SlamParameters(), device="cpu", verbose=False)
    j = jlc.LoopClosing(jm, None, None, JParams(), verbose=False)
    for lc, kfs in ((p, pk), (j, jk)):
        lc.current_kf, lc.matched_kf = kfs[cur], kfs[matched]
    return (p, pk, pp), (j, jk, jp)


def _geometry(kfs, mps):
    return ({i: kf.get_pose() for i, kf in kfs.items() if not kf.is_bad},
            {i: mp.world_pos.copy() for i, mp in mps.items() if not mp.is_bad})


def _assert_geometry_close(a, b, atol):
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_allclose(x[k], y[k], atol=atol, err_msg=str(k))


def test_prealign_matches_jax_on_twin_maps(drifted):
    _, snap, cur, matched, pairs = drifted
    (p, pk, pp), (j, jk, jp) = _closers(snap, cur, matched)
    before = _geometry(pk, pp)
    assert p._prealign_loop([(pp[a], pp[b]) for a, b in pairs])
    assert j._prealign_loop([(jp[a], jp[b]) for a, b in pairs])
    got, ref = _geometry(pk, pp), _geometry(jk, jp)
    _assert_geometry_close(got, ref, atol=1e-4)
    moved = max(float(np.abs(got[0][k] - before[0][k]).max()) for k in got[0])
    assert moved > 1e-3, moved  # the loop edge moved the chain
    fit = p.last_prealign
    assert fit["nodes"] == len(pk) and abs(fit["translation"] - np.linalg.norm(
        chip_smoke.SURGICAL_DRIFT)) < 5e-3


def test_gba_propagation_matches_jax(drifted, monkeypatch):
    """Stage one seeded loop-GBA result in both packages (every keyframe but
    the newest tracked one, every other point) and compare what the
    spanning-tree propagation and the re-anchoring make of it."""
    _, snap, cur, matched, _ = drifted
    (p, pk, pp), (j, jk, jp) = _closers(snap, cur, matched)
    rng = np.random.default_rng(3)
    # the newest tracked keyframe is left for the spanning tree to reach; the
    # revisit keyframe, outside the tree until the fuse connects it, stays
    # unstaged
    tracked = sorted(k for k, kf in pk.items() if not kf.is_bad and k != cur)
    kf_ids = tracked[:-1]
    mp_ids = sorted(m for m, mp in pp.items() if not mp.is_bad)[::2]
    T_gba = {}
    for k in kf_ids:
        xi = rng.normal(size=6) * 0.01
        T_gba[k] = chip_smoke.se3.exp_se3(torch.from_numpy(xi)).numpy().astype(np.float32) @ \
            pk[k].get_pose()
    X_gba = {m: (pp[m].world_pos + rng.normal(size=3) * 0.01).astype(np.float32) for m in mp_ids}

    def stage(kfs, mps):
        def run_global_ba(map_, *args, loop_kf=0, **kw):
            for k in kf_ids:
                kfs[k].Tcw_gba, kfs[k].ba_global_for_kf = T_gba[k].copy(), loop_kf
            for m in mp_ids:
                mps[m].pos_gba, mps[m].ba_global_for_kf = X_gba[m].copy(), loop_kf
        return run_global_ba

    monkeypatch.setattr(plc, "run_global_ba", stage(pk, pp))
    monkeypatch.setattr(jlc, "run_global_ba", stage(jk, jp))
    for lc in (p, j):
        lc.fuse_duplicates = True
        lc.run_global_bundle_adjustment(cur)
    _assert_geometry_close(_geometry(pk, pp), _geometry(jk, jp), atol=1e-6)
    for k in tracked:
        assert pk[k].ba_global_for_kf == jk[k].ba_global_for_kf == cur
        np.testing.assert_allclose(pk[k].Tcw_bef_gba, jk[k].Tcw_bef_gba, atol=1e-6)
    assert pk[cur].ba_global_for_kf == jk[cur].ba_global_for_kf == -1
    assert p.map.big_change_idx == j.map.big_change_idx == snap["big_change_idx"] + 1


def test_replace_moves_versions_as_jax(drifted):
    _, snap, _, _, pairs = drifted
    (pm, pk, pp), (jm, jk, jp) = _twins(snap)
    assert {k: kf.keypoint_map.version for k, kf in pk.items()} == \
        {k: kf.keypoint_map.version for k, kf in jk.items()}
    before = {k: (kf.keypoint_map.version, sorted(
        (i, it.map_point.id) for i, it in kf.keypoint_map.items())) for k, kf in pk.items()}
    for kfs, mps in ((pk, pp), (jk, jp)):
        for a, b in pairs:
            if not (mps[a].is_bad or mps[b].is_bad):
                mps[a].replace(mps[b])
    versions = {k: kf.keypoint_map.version for k, kf in pk.items()}
    assert versions == {k: kf.keypoint_map.version for k, kf in jk.items()}
    changed = [k for k, kf in pk.items() if sorted(
        (i, it.map_point.id) for i, it in kf.keypoint_map.items()) != before[k][1]]
    assert changed and all(versions[k] > before[k][0] for k in changed)
    assert sorted(m for m, mp in pp.items() if mp.is_bad) == \
        sorted(m for m, mp in jp.items() if mp.is_bad)


def test_detect_and_correct_loop_prealign_on(drifted):
    setup = drifted[0]
    rec = chip_smoke.run_surgical_loop(setup)
    fit = rec["prealign_fit"]
    assert fit["nodes"] == rec["keyframes"] and fit["edges"] >= fit["nodes"] - 1
    assert rec["fused"] > 0 and abs(fit["scale"] - 1.0) < 0.05
