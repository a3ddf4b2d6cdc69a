"""Port parity for the slice as a whole: the steady tracking step.

At the sizes of __graft_entry__.entry (240x320, 512 features, 4 local
keyframes, tables of 256), on a map seeded from the simulator's geometry
(chip_smoke.seed_tables):

  * `_steady_core` on the JAX package's own features and tables, carried
    over with convert.py: T1 and T2 within atol 1e-4 (the pose LMs' f32
    reassociation), row / new_row / vis at least 99 % identical;
  * `steady_step` end to end (each side extracts its own features): T2
    within atol 1e-3;
  * chip_smoke's chained drive on the CPU against ground truth;
  * the port, every subpackage of the host pipeline included, imports with
    JAX blocked.
"""

import functools
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from torch_parity import jax_features_np
from mono_slam_framework_tpu.ops import orb as jorb
from mono_slam_framework_tpu.slam import fused_tracking as jft
from mono_slam_framework_torch import convert, sim
from mono_slam_framework_torch.slam import fused_tracking

CFG = chip_smoke.SMALL
STATICS = dict(ratio=chip_smoke.RATIO, cols=CFG.w, width=float(CFG.w),
               height=float(CFG.h), use_octave_info=True)


@functools.partial(jax.jit, static_argnames=("max_features",))
def _jax_extract(img, max_features):
    return jorb.extract(img, max_features, use_fused=False)


@functools.partial(
    jax.jit, static_argnames=("ratio", "cols", "width", "height", "use_octave_info")
)
def _jax_steady_core(cur, *state, **statics):
    return jft._steady_core(cur, *state, **statics)


@pytest.fixture(scope="module")
def scene():
    """JAX features of the keyframes and of the current frame, the seeded
    tables, and the steady-step state of the first tracked frame."""
    world, poses, images = chip_smoke.render(CFG._replace(n_frames=1))
    n = CFG.n_kf
    kf = [jax_features_np(_jax_extract(images[k], CFG.max_features)) for k in range(n)]
    cur = jax_features_np(_jax_extract(images[n], CFG.max_features))
    t = chip_smoke.seed_tables(
        CFG, world, poses, [f["xy"] for f in kf], [f["valid"] for f in kf]
    )
    T_init = np.asarray(fused_tracking.chain_T_init(
        torch.from_numpy(poses[n - 1]), torch.from_numpy(poses[n - 2])
    ))
    kf_stacked = {k: np.stack([f[k] for f in kf]) for k in kf[0]}
    state = (
        kf[n - 1], t["kf_px"][n - 1], t["kf_row"][n - 1], t["mp_pos"], T_init,
        kf_stacked, t["kf_px"], t["kf_row"], t["first_slot"], t["normal"],
        t["maxdist"], world.K,
    )
    return images[n], poses[n], cur, state


def _jax_state(state):
    """numpy state -> JAX pytrees (Features from the JAX package)."""
    def feats(d):
        return jorb.Features(**{k: jax.numpy.asarray(v) for k, v in d.items()})

    return tuple(feats(x) if isinstance(x, dict) else jax.numpy.asarray(x) for x in state)


@pytest.fixture(scope="module")
def jax_core(scene):
    _, _, cur, state = scene
    cur_j, *state_j = _jax_state((cur,) + state)
    _, packed, chain_px, union_row, T2 = _jax_steady_core(cur_j, *state_j, **STATICS)
    packed = np.asarray(packed)
    k = len(cur["valid"])
    r = len(state[8])  # first_slot
    # the packed layout of fused_tracking._steady_core
    motion = 18 + 8 * k
    return {
        "T1": packed[:16].reshape(4, 4),
        "n_good1": packed[16],
        "row": packed[18 : 18 + k].astype(np.int32),
        "T2": packed[motion : motion + 16].reshape(4, 4),
        "n_good2": packed[motion + 16],
        "new_row": packed[motion + 17 : motion + 17 + k].astype(np.int32),
        "vis": packed[motion + 17 + 2 * k : motion + 17 + 2 * k + r] > 0.5,
        "chain_px": np.asarray(chain_px),
        "union_row": np.asarray(union_row),
    }


def test_steady_core_matches_jax(scene, jax_core):
    _, _, cur, state = scene
    inputs = convert.steady_inputs_from_numpy(*state, device="cpu")
    out = fused_tracking._steady_core(
        convert.features_from_numpy(cur, device="cpu"), *inputs, **STATICS
    )
    ref = jax_core
    np.testing.assert_allclose(out.motion.T1.numpy(), ref["T1"], atol=1e-4)
    np.testing.assert_allclose(out.local.T2.numpy(), ref["T2"], atol=1e-4)
    assert (out.motion.row.numpy() == ref["row"]).mean() >= 0.99
    assert (out.local.new_row.numpy() == ref["new_row"]).mean() >= 0.99
    assert (out.local.vis.numpy() == ref["vis"]).mean() >= 0.99
    assert (out.union_row.numpy() == ref["union_row"]).mean() >= 0.99
    assert (out.chain_px.numpy() == ref["chain_px"]).mean() >= 0.99
    # the step did real work: associations in both phases
    assert (ref["row"] >= 0).sum() > 20 and ref["vis"].sum() > 0
    assert abs(int(out.local.n_good) - int(ref["n_good2"])) <= 2


def test_steady_step_end_to_end(scene, jax_core):
    img, T_gt, _, state = scene
    inputs = convert.steady_inputs_from_numpy(*state, device="cpu")
    out = fused_tracking.steady_step(
        torch.from_numpy(img), *inputs, **STATICS,
        max_features=CFG.max_features, fast_threshold=chip_smoke.FAST_THRESHOLD,
    )
    # JAX's steady_step is its extract + _steady_core, the reference above
    np.testing.assert_allclose(out.local.T2.numpy(), jax_core["T2"], atol=1e-3)
    c_err, _ = chip_smoke.pose_errors(out.local.T2.numpy()[None], T_gt[None])
    assert c_err[0] < 0.03


def test_motion_and_local_steps_compose(scene):
    """motion_step then local_step, with the candidate mask and frustum pose
    the one-step program uses, give steady_step's outputs."""
    img, _, _, state = scene
    inputs = convert.steady_inputs_from_numpy(*state, device="cpu")
    (prev, prev_px, prev_row, mp_pos, T_init, kf, kf_px, kf_row, first_slot,
     normal, maxdist, K) = inputs
    extract = dict(max_features=CFG.max_features, fast_threshold=chip_smoke.FAST_THRESHOLD)
    one = fused_tracking.steady_step(torch.from_numpy(img), *inputs, **STATICS, **extract)
    cur, mo = fused_tracking.motion_step(
        torch.from_numpy(img), prev, prev_px, prev_row, mp_pos, T_init, K,
        STATICS["ratio"], CFG.w, True, **extract,
    )
    np.testing.assert_array_equal(mo.T1.numpy(), one.motion.T1.numpy())
    np.testing.assert_array_equal(mo.row.numpy(), one.motion.row.numpy())
    assert int(mo.n_matches) == int(one.motion.n_matches)
    cur_row = torch.where(mo.keep & mo.inlier, mo.row, -1)
    seen = torch.zeros(len(mp_pos), dtype=torch.bool)
    seen[mo.row[mo.keep].long()] = True
    lo = fused_tracking.local_step(
        cur, cur_row, mo.T1, kf, kf_px, kf_row, ~seen[: len(first_slot)],
        first_slot, normal, maxdist, mp_pos, mo.T1, K, **STATICS,
    )
    np.testing.assert_array_equal(lo.T2.numpy(), one.local.T2.numpy())
    np.testing.assert_array_equal(lo.new_row.numpy(), one.local.new_row.numpy())
    np.testing.assert_array_equal(lo.vis.numpy(), one.local.vis.numpy())


def test_sim_rejects_unknown_plane_axis():
    with pytest.raises(ValueError, match="axis"):
        sim.PlaneWorld(second_plane=[(3.0, 0.3, "z")])


def test_features_roundtrip(scene):
    _, _, cur, _ = scene
    f = convert.features_from_numpy(cur, device="cpu")
    assert f.desc.dtype == torch.int32 and f.octave.dtype == torch.int32
    back = convert.features_to_numpy(f)
    for k, v in cur.items():
        np.testing.assert_array_equal(back[k], v)


def test_chained_drive_tracks_ground_truth():
    """chip_smoke's drive on the CPU at the small size: 6 chained frames on
    the seeded map stay within 3 cm / 0.5 deg of ground truth (the run here
    measured at most 1.4 cm / 0.23 deg)."""
    dev = torch.device("cpu")
    world, poses, images = chip_smoke.render(CFG)
    seed = chip_smoke.seed_map(dev, CFG, world, poses, images)
    run = chip_smoke.drive(dev, CFG, seed, poses, images)
    c_err, r_err = chip_smoke.pose_errors(run.T2, np.stack(poses[CFG.n_kf:]))
    assert run.T2.shape == (CFG.n_frames, 4, 4) and np.isfinite(run.T2).all()
    assert c_err.max() < 0.03, c_err
    assert r_err.max() < 0.5, r_err
    assert run.n_good2.min() > 70, run.n_good2


def test_port_imports_without_jax():
    root = pathlib.Path(__file__).resolve().parents[1]
    pkg = root / "mono_slam_framework_torch"
    mods = sorted(
        ".".join(p.relative_to(root).with_suffix("").parts)
        for p in pkg.rglob("*.py")
        if p.name != "__init__.py"
    )
    tools = sorted(p.stem for p in (root / "tools").glob("torch_*.py"))
    code = (
        "import sys; sys.modules['jax'] = None; "
        "sys.modules['mono_slam_framework_tpu'] = None; "
        "sys.path.insert(0, 'tools'); "
        + "; ".join(f"import {m}" for m in mods + ["chip_smoke"] + tools)
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True
    )
    assert proc.returncode == 0, proc.stderr
    # every subpackage of the host pipeline is among them
    prefix = "mono_slam_framework_torch."
    for sub in ("estimation", "slam", "io", "viz", "utils", "params", "geometry", "optim"):
        assert any(m.startswith(prefix + sub) for m in mods), sub
    # relocalization and loop correction
    for m in ("estimation.epnp", "optim.pose_graph", "geometry.sim3", "slam.loop_closing"):
        assert prefix + m in mods, m
    # the application layer and the native runtime's bindings
    for m in ("run", "ab_sweep", "interactive", "quality_bench", "io.datasets", "utils.app",
              "native.frameio"):
        assert prefix + m in mods, m
    # multi-stream serving
    for m in ("parallel.multistream", "parallel.server"):
        assert prefix + m in mods, m
    # the multi-device layer
    for m in ("parallel.mesh", "parallel.sweep", "parallel.ba_sharded", "parallel.loftr_tp"):
        assert prefix + m in mods, m
    assert len(mods) >= 40 and len(tools) >= 3
