"""The port's application layer against the JAX package's.

  * `run.main --device cpu` over a 320x240, 16-frame TUM sequence: it ends
    OK with >= 2 keyframes and ATE < 1.0 (tests/test_runner.py's mechanics
    bound), prints the JAX runner's summary keys, and its `--map-out`
    reloads into a System with the same counts and covisibility;
  * argv -> SlamParameters (and the printed summary) equal to the JAX
    `run.main`'s: both packages' `System` is replaced by one recorder, so
    no JAX System runs;
  * `GammaCorrector`'s LUT equal to the JAX one; `AsyncSlamDriver` drops
    frames while a step is in flight;
  * `ab_sweep.main`'s ORB arm on the same sequence;
  * `Rig` poses and `_ansi_preview` strings equal to the JAX ones for one
    key stream; a scripted `run_interactive` at 320x240;
  * `quality_bench.run_quality(n_poses=8)` and `run_quality_loftr(n_poses=3)`
    on the CPU return the keys of the JAX functions (run with the recorder);
  * the fork twin (`quality_bench.run_fork_twin`) on a small map with staged
    global-BA markers leaves every marker, pose and position as it was.
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest

import torch_parity  # noqa: F401  (pins torch to one thread)
import mono_slam_framework_tpu.slam as jslam
from mono_slam_framework_tpu import interactive as jinteractive
from mono_slam_framework_tpu import quality_bench as jquality
from mono_slam_framework_tpu import run as jrun
from mono_slam_framework_tpu.slam.tracking import TrackingState as JState
from mono_slam_framework_tpu.utils import GammaCorrector as JGamma
import mono_slam_framework_torch.slam as pslam
from mono_slam_framework_torch import ab_sweep, interactive, quality_bench, run, sim
from mono_slam_framework_torch.matchers import OrbFeatureMatcher
from mono_slam_framework_torch.params import SlamParameters
from mono_slam_framework_torch.slam import KeyFrameMatchDatabase, System
from mono_slam_framework_torch.slam.frame import Frame, reset_frame_ids
from mono_slam_framework_torch.slam.map_model import KeyFrame, MapPoint, reset_map_ids
from mono_slam_framework_torch.slam.tracking import TrackingState
from mono_slam_framework_torch.utils import AsyncSlamDriver, GammaCorrector

N_FRAMES = 16


@pytest.fixture(scope="module")
def mini_tum(tmp_path_factory):
    """tests/test_runner.py's mini-TUM sequence (320x240 plane world, PNGs,
    rgb.txt and groundtruth.txt), 16 frames."""
    from PIL import Image

    root = tmp_path_factory.mktemp("tum_seq")
    world = sim.PlaneWorld(second_plane=(3.0, 0.3))
    os.makedirs(root / "rgb")
    lines, gt_lines = [], []
    for i, T in enumerate(sim.lateral_trajectory(N_FRAMES, step=0.09)):
        ts = i * 0.1
        name = f"rgb/{ts:.6f}.png"
        Image.fromarray(world.render(T).astype(np.uint8), "L").save(root / name)
        lines.append(f"{ts:.6f} {name}")
        Ow = -(T[:3, :3].T @ T[:3, 3])
        gt_lines.append(f"{ts:.6f} {Ow[0]:.6f} {Ow[1]:.6f} {Ow[2]:.6f} 0 0 0 1")
    (root / "rgb.txt").write_text("# tum\n" + "\n".join(lines) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")
    return str(root), world


def _argv(root, world, *extra):
    return ["--dataset", "tum", "--path", root, "--matcher", "orb",
            "--fx", str(world.f), "--fy", str(world.f),
            "--cx", str(world.cx), "--cy", str(world.cy),
            "--features", "400", "--ratio", "0.7", "--model-fallback", "--quiet",
            "--ate", *extra]


def _summary(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


class Recorder:
    """Stands in for either package's System: records its parameters and
    the frames it is given, reports OK, and writes the ground truth of the
    sequence (`gt`) as its trajectories."""

    gt = ""
    state = None  # the package's TrackingState.OK, for quality_bench

    def __init__(self, params, matcher, kf_db, verbose=True, **kw):
        self.params, self.kw, self.frames = params, kw, []
        self.map = type("M", (), {"n_keyframes": lambda s: 2, "n_map_points": lambda s: 30})()
        self.last_metrics = {"state": "OK"}
        self.tracker = type("T", (), {"state": self.state})()
        self.loop_closer = type("L", (), {"correct_loop": None, "fuse_duplicates": True,
                                          "last_fuse_count": 0, "last_loop_kf_id": 0})()
        self.made.append(self)

    def track_monocular(self, image, timestamp):
        self.frames.append(timestamp)

    track_monocular_pipelined = track_monocular

    def flush_pipeline(self):
        pass

    def toggle_initialization_allowed(self):
        pass

    def set_minimum_keyframes(self, n):
        pass

    def save_keyframe_trajectory_tum(self, path):
        with open(path, "w") as f:
            f.write(self.gt)

    save_trajectory_tum = save_keyframe_trajectory_tum

    def save_checkpoint(self, path):
        with open(path, "wb") as f:
            f.write(b"")


@pytest.fixture
def recorders(monkeypatch, mini_tum):
    """Both packages' System replaced by a Recorder; yields {package: list
    of the recorders made}."""
    with open(os.path.join(mini_tum[0], "groundtruth.txt")) as f:
        gt = f.read()
    made = {}
    for name, mod, state in (("jax", jslam, JState.OK), ("port", pslam, TrackingState.OK)):
        made[name] = []
        cls = type(f"Recorder_{name}", (Recorder,),
                   {"made": made[name], "gt": gt, "state": state})
        monkeypatch.setattr(mod, "System", cls)
    return made


# ---------------------------------------------------------------------------
# run.py


def test_cli_end_to_end(mini_tum, tmp_path, capsys):
    root, world = mini_tum
    out, ckpt = tmp_path / "traj.txt", tmp_path / "map.npz"
    run.main(_argv(root, world, "--out", str(out), "--map-out", str(ckpt), "--device", "cpu"))
    summary = _summary(capsys)
    assert sorted(summary) == ["ate_pairs", "ate_rmse", "final_state", "fps", "frames",
                               "keyframes", "map_points"]
    assert summary["frames"] == N_FRAMES
    assert summary["keyframes"] >= 2
    assert summary["final_state"] == "OK"
    assert summary["ate_rmse"] < 1.0  # CLI mechanics; quality bounds live elsewhere
    assert out.exists()

    reset_frame_ids()
    reset_map_ids()
    m = OrbFeatureMatcher(0.7, 400, device="cpu")
    other = System(SlamParameters(fx=world.f, fy=world.f, cx=world.cx, cy=world.cy),
                   m, KeyFrameMatchDatabase(m), verbose=False, device="cpu")
    other.load_checkpoint(str(ckpt))
    assert other.map.obs_graph is not None
    assert other.map.n_keyframes() == summary["keyframes"]
    assert other.map.n_map_points() == summary["map_points"]
    kfs = other.map.all_keyframes()
    assert all(kf.connections for kf in kfs)
    assert {kf.id for kf in kfs[1:] if kf.parent is not None} == {kf.id for kf in kfs[1:]}


ARGVS = {
    "defaults": [],
    "unfused": ["--no-fused", "--no-fused-one-step", "--min-ini-matches", "60"],
    "pipelined": ["--pipelined", "--reloc-cooldown-inlier-floor", "40", "--gamma", "0.8",
                  "--max-frames", "5", "--init-frame", "2"],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_argv_to_parameters_equals_jax(mini_tum, recorders, tmp_path, capsys, case):
    root, world = mini_tum
    out = str(tmp_path / "traj.txt")
    jrun.main(_argv(root, world, "--out", out, *ARGVS[case]))
    jax_summary = _summary(capsys)
    run.main(_argv(root, world, "--out", out, "--device", "cpu", *ARGVS[case]))
    port_summary = _summary(capsys)
    (j,), (p,) = recorders["jax"], recorders["port"]
    assert dataclasses.asdict(p.params) == dataclasses.asdict(j.params)
    assert p.kw == {"device": "cpu"}
    assert p.frames == j.frames
    jax_summary.pop("fps"), port_summary.pop("fps")
    assert port_summary == jax_summary


# ---------------------------------------------------------------------------
# utils/app.py


def test_gamma_lut_equals_jax():
    img = np.linspace(-20, 300, 48 * 64).reshape(48, 64).astype(np.float32)
    for g in (1.0, 0.45, 0.8, 2.2):
        got, want = GammaCorrector(g), JGamma(g)
        np.testing.assert_array_equal(got._lut, want._lut)
        np.testing.assert_array_equal(got(img), want(img))


def test_async_driver_drops_while_busy():
    release = threading.Event()

    class Blocking:
        def __init__(self):
            self.calls = []

        def track_monocular(self, image, ts):
            self.calls.append(ts)
            assert release.wait(timeout=30)

    s = Blocking()
    d = AsyncSlamDriver(s)
    accepted = [d.feed(None, 0.01 * i) for i in range(5)]
    assert accepted == [True, False, False, False, False]
    release.set()
    d.wait()
    assert d.feed(None, 0.1)
    d.close()
    assert not d._thread.is_alive()
    assert s.calls == [0.0, 0.1]
    assert (d.frames_in, d.frames_dropped) == (6, 4)


# ---------------------------------------------------------------------------
# ab_sweep.py


def test_ab_sweep_orb_arm(mini_tum, tmp_path, capsys):
    root, world = mini_tum
    results = ab_sweep.main(["--dataset", "tum", "--path", root, "--matchers", "orb",
                             "--fx", str(world.f), "--fy", str(world.f),
                             "--cx", str(world.cx), "--cy", str(world.cy),
                             "--features", "400", "--ratio", "0.7", "--model-fallback",
                             "--out-prefix", str(tmp_path / "ab"), "--ate", "--device", "cpu"])
    (r,) = results
    assert r["matcher"] == "orb" and r["frames"] == N_FRAMES
    assert r["final_state"] == "OK"
    assert r["ate_rmse"] < 1.0
    assert "tracking" in r["stage_timing"]
    assert json.loads(capsys.readouterr().out)["sweep"][0]["frames"] == N_FRAMES


# ---------------------------------------------------------------------------
# interactive.py


def test_rig_and_preview_equal_jax():
    keys = ["right", "up", "c", None, "f", "a", "z", "space", "w", "b", "d", "s", None]
    rigs = (interactive.Rig(), jinteractive.Rig())
    for tok in keys:
        assert rigs[0].key(tok) == rigs[1].key(tok)
        for r in rigs:
            r.tick()
        np.testing.assert_array_equal(rigs[0].tcw(), rigs[1].tcw())
    world = sim.PlaneWorld()
    img = world.render(rigs[0].tcw())
    for cols in (48, 96):
        assert interactive._ansi_preview(img, cols) == jinteractive._ansi_preview(img, cols)
    rgb = np.stack([img, img * 0.5, 255 - img], axis=2)
    assert interactive._ansi_preview(rgb) == jinteractive._ansi_preview(rgb)


def test_scripted_session_tracks_and_saves(tmp_path):
    reset_frame_ids()
    reset_map_ids()
    world = sim.PlaneWorld(width=320, height=240, f=250.0, second_plane=(3.0, 0.3))
    m = OrbFeatureMatcher(threshold=0.7, max_features=1000, device="cpu")
    params = SlamParameters(fx=world.f, fy=world.f, cx=world.cx, cy=world.cy,
                            max_features=1000, minIniMatchCount=100,
                            initializerModelFallback=True)
    system = System(params, m, KeyFrameMatchDatabase(m), verbose=False, device="cpu")
    out, png = str(tmp_path / "traj.txt"), str(tmp_path / "match.png")
    keys = ["i"] + ["right"] * 3 + [None] * 13 + ["t"]
    summary = interactive.run_interactive(system, world, keys=keys, png=png, png_every=10,
                                          out=out, verbose=False)
    assert summary["frames"] == len(keys)
    assert summary["dropped"] == 0  # scripted sessions are synchronous
    assert summary["state"] == "OK", summary
    assert summary["keyframes"] >= 2
    assert summary["trajectory_saves"] == 1
    assert os.path.getsize(out) > 0 and os.path.exists(png)


# ---------------------------------------------------------------------------
# quality_bench.py


def test_quality_arms_return_the_jax_keys(recorders, monkeypatch):
    jax_keys = sorted(jquality.run_quality(n_poses=8, both_arms=True))
    jax_loftr_keys = sorted(jquality.run_quality_loftr(n_poses=3))
    assert len(recorders["jax"]) == 2
    monkeypatch.setattr(pslam, "System", System)  # the port's arms run for real
    got = quality_bench.run_quality(n_poses=8, device="cpu", both_arms=True)
    assert sorted(got) == jax_keys
    assert got["quality_frames_ok_share"] > 0 and got["loop_detected"] is False
    got = quality_bench.run_quality_loftr(n_poses=3, device="cpu")
    assert sorted(got) == jax_loftr_keys
    assert got["quality_loftr_poses"] == 3


def _staged_system():
    """A CPU System whose map holds 4 keyframes along a lateral path and 60
    points seen by 2-4 of them (projections with noise), connected and
    chained from the origin, with every global-BA marker staged under a
    stale loop id."""
    reset_frame_ids()
    reset_map_ids()
    rng = np.random.default_rng(3)
    world = sim.PlaneWorld(width=160, height=120, f=125.0)
    K = np.array([[125.0, 0, 80], [0, 125.0, 60], [0, 0, 1]], np.float32)
    m = OrbFeatureMatcher(0.7, 200, device="cpu")
    system = System(SlamParameters(fx=125.0, fy=125.0, cx=80.0, cy=60.0), m,
                    KeyFrameMatchDatabase(m), verbose=False, device="cpu")
    map_ = system.map
    poses = sim.lateral_trajectory(4, step=0.1)
    kfs = []
    for i, T in enumerate(poses):
        fr = Frame(np.zeros((world.h, world.w), np.float32), 0.1 * i, K)
        fr.set_pose(T)
        kf = KeyFrame(fr, map_, None)
        map_.add_keyframe(kf)
        kfs.append(kf)
    map_.keyframe_origins.append(kfs[0])
    for j in range(60):
        pos = np.array([rng.uniform(-1, 1), rng.uniform(-0.7, 0.7), rng.uniform(4, 6)])
        mp = MapPoint(pos + rng.normal(0, 0.02, 3), kfs[0], map_)
        for k in sorted(rng.choice(4, rng.integers(2, 5), replace=False)):
            T = poses[k]
            Xc = T[:3, :3] @ pos + T[:3, 3]
            uv = K[:2, :2] @ (Xc[:2] / Xc[2]) + K[:2, 2] + rng.normal(0, 0.5, 2)
            px = (int(uv[0]), int(uv[1]))
            kfs[k].keypoint_map.set_map_point(px, mp, measurement=tuple(uv))
            mp.add_observation(kfs[k], px, measurement=tuple(uv))
        mp.update_normal_and_depth()
        map_.add_map_point(mp)
    for kf in kfs:
        kf.update_connections()
    for parent, kf in zip(kfs, kfs[1:]):  # the spanning tree as a chain from the origin
        kf.parent.erase_child(kf)
        kf.change_parent(parent)
    for kf in kfs:
        kf.Tcw_gba = rng.normal(size=(4, 4)).astype(np.float32)
        kf.Tcw_bef_gba = rng.normal(size=(4, 4)).astype(np.float32)
        kf.ba_global_for_kf = 999
    for mp in map_.all_map_points():
        mp.pos_gba = rng.normal(size=3).astype(np.float32)
        mp.ba_global_for_kf = 999
    system.loop_closer.current_kf = kfs[-1]
    return system


def _state(system):
    kfs = sorted(system.map.all_keyframes(), key=lambda k: k.id)
    mps = sorted(system.map.all_map_points(), key=lambda m: m.id)
    return ([(kf.get_pose(), kf.Tcw_gba, kf.Tcw_bef_gba, kf.ba_global_for_kf) for kf in kfs],
            [(mp.world_pos, mp.pos_gba, mp.ba_global_for_kf) for mp in mps])


def _assert_same(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            np.testing.assert_array_equal(x, y)


def test_fork_twin_restores_the_staged_markers():
    """ROADMAP C.5: the twin's loop GBA stages its own markers under the
    loop keyframe's id; the twin puts back every marker it found, not only
    the poses and positions."""
    system = _staged_system()
    before = _state(system)
    seen = {}

    def ate_now():  # called after the twin's GBA, before the restore
        seen["kf_markers"] = {kf.ba_global_for_kf for kf in system.map.all_keyframes()}
        seen["poses"] = _state(system)[0]
        return 0.25

    assert quality_bench.run_fork_twin(system, ate_now) == 0.25
    loop_id = system.loop_closer.current_kf.id
    assert seen["kf_markers"] == {loop_id}  # the GBA ran and staged its markers
    assert any(not np.array_equal(a[0], b[0]) for a, b in zip(seen["poses"], before[0]))
    after = _state(system)
    _assert_same(after[0], before[0])
    _assert_same(after[1], before[1])
    assert system.loop_closer.fuse_duplicates is True
    assert system.loop_closer.local_mapper is system.local_mapper
