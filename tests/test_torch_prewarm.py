"""The port's background warm (utils/prewarm.py) on the CPU.

tests/test_prewarm.py's cases on the port (auto mode is a no-op on the CPU;
pinned execution runs in the background, dedupes and drains; an executed
warm leaves the real call's result equal; the warm's problem runs through
the port's solver: here the essential graph, the one warm the port keeps,
where the JAX test takes its local-BA spec), then what the port adds:
failures are counted, never raised; the tracker's generator is untouched;
the worker takes the asking thread's grad mode; the port requests the
essential graph at the JAX package's sizes (recorded in both packages,
nothing run); a System asks for its warm by its own flag; a System drive
with execution pinned is bit-equal to the same drive with the warm off;
run.py's --prewarm flag; two graph solves in two threads at once.
"""

import ast
import pathlib
import threading
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import torch_parity  # noqa: F401  (pins torch to one thread)
from mono_slam_framework_torch.geometry import se3
from mono_slam_framework_torch.matchers import OrbFeatureMatcher
from mono_slam_framework_torch.optim.pose_graph import optimize_pose_graph
from mono_slam_framework_torch.params import SlamParameters
from mono_slam_framework_torch.slam import KeyFrameMatchDatabase, System, device_io
from mono_slam_framework_torch.utils import prewarm as pw
from mono_slam_framework_torch.utils.prewarm import Spec

CPU = torch.device("cpu")
F32 = torch.float32
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def fresh_state():
    pw.set_enabled(True)
    pw.set_execute(None)
    pw._seen.clear()
    pw._failures.clear()
    pw._timings.clear()
    yield
    assert pw.wait(60)
    pw.set_enabled(True)
    pw.set_execute(None)
    pw._seen.clear()
    pw._failures.clear()


def test_cpu_auto_mode_is_noop():
    calls = []
    assert pw.prewarm(lambda x: calls.append(x), Spec((5,), F32)) is False
    assert pw.pending() == 0 and calls == []


def test_executes_in_background_dedups_and_drains():
    seen = []

    def f(x):
        seen.append((tuple(x.shape), threading.current_thread().name))
        return x * 2.0

    pw.set_execute(True)
    spec = Spec((37,), F32)
    assert pw.prewarm(f, spec) is True
    assert pw.prewarm(f, spec) is False  # same key: dropped
    assert pw.prewarm(f, Spec((64,), F32)) is True
    assert pw.wait(30) and pw.pending() == 0
    assert sorted(seen) == [((37,), "shape-prewarm"), ((64,), "shape-prewarm")]
    assert [name for name, ms in pw.timings()] == ["f", "f"]
    pw.set_execute(False)  # drain mode: queued, never called
    assert pw.prewarm(f, Spec((9,), F32)) is True
    assert pw.wait(30) and len(seen) == 2


def _off_optimum(N, E):
    """device_io.graph_problem's graph with every node moved off its
    optimum, so that a solve has work to do."""
    T, fixed, e_i, e_j, T_meas, w = device_io.graph_problem(N, E)
    return (se3.exp_se3(torch.full((N, 6), 0.01)) @ T, fixed, e_i, e_j, T_meas, w)


def test_executed_warm_leaves_the_real_call_equal():
    args = _off_optimum(5, 8)
    before = optimize_pose_graph(*args, iters=3)
    pw.set_execute(True)
    with mock.patch.object(device_io, "GRAPH_WARM_SIZES", ((5, 8),)):
        device_io.prewarm_startup_shapes(CPU)
    assert pw.wait(30) and pw.failures() == [] and len(pw.timings()) == 1
    after = optimize_pose_graph(*args, iters=3)
    for a, b in zip(before, after):
        assert torch.equal(a, b)


@pytest.mark.parametrize("size", device_io.GRAPH_WARM_SIZES)
def test_graph_warm_problem_runs_through_the_solver(size):
    N, E = size
    problem = device_io.graph_problem(N, E)
    T, fixed, e_i, e_j, T_meas, w = problem
    assert [tuple(t.shape) for t in problem] == [(N, 4, 4), (N,), (E,), (E,), (E, 4, 4), (E,)]
    assert bool((e_i < e_j).all()) and int(e_j.max()) == N - 1 and fixed.sum() == 1
    T_out, cost = optimize_pose_graph(*problem, iters=2)
    assert torch.isfinite(T_out).all() and float(cost) < 1e-8  # exact measurements
    T_out, cost = optimize_pose_graph(*_off_optimum(N, E), iters=2)
    assert torch.isfinite(T_out).all() and float(cost) < 1e-6


def test_a_failing_warm_is_counted_not_raised():
    def boom(x):
        raise ValueError("bad warm")

    pw.set_execute(True)
    assert pw.prewarm(boom, Spec((3,), F32)) is True
    assert pw.wait(30)
    assert pw.failures() == [("boom", "ValueError('bad warm')")]


def test_warm_leaves_the_tracker_generator_alone():
    world = chip_smoke.render_system(chip_smoke.SYSTEM_SMALL._replace(n_warm=1, n_timed=0))[0]
    pw.set_execute(True)  # the System's own warm runs here
    system = _system(world, prewarm_on=True)
    gen_state, global_state = system.tracker._generator.get_state(), torch.random.get_rng_state()
    assert pw.wait(60) and pw.failures() == [] and len(pw.timings()) == 2
    assert torch.equal(system.tracker._generator.get_state(), gen_state)
    assert torch.equal(torch.random.get_rng_state(), global_state)


def test_worker_takes_the_asking_thread_grad_mode():
    modes = []

    def f(x):
        modes.append((torch.is_grad_enabled(), torch.is_inference_mode_enabled()))

    pw.set_execute(True)
    with torch.no_grad():
        pw.prewarm(f, Spec((1,), F32))
    pw.prewarm(f, Spec((2,), F32))
    with torch.inference_mode():
        pw.prewarm(f, Spec((3,), F32))
    assert pw.wait(30)
    assert modes == [(False, False), (True, False), (False, True)]


# ---------------------------------------------------------------------------
# the twin request lists: recorded in both packages, nothing run


def _shapes(leaves) -> list:
    return [(tuple(x.shape), str(x.dtype).split(".")[-1].replace("int32", "int64"))
            for x in leaves]


def _record(monkeypatch, mod, leaves_of):
    log = []

    def rec(fn, *args, **kwargs):
        log.append((fn.__name__, _shapes(leaves_of(args))))
        return True

    monkeypatch.setattr(mod, "prewarm", rec)
    return log


def test_twin_request_lists(monkeypatch):
    """The port's start-up warm requests the essential graph at the JAX
    package's sizes, the padded-edge mask aside; the JAX package's other
    start-up requests (local BA, the sweep, batched matching) fill its
    compile cache and have no counterpart."""
    from mono_slam_framework_tpu.matchers import OrbFeatureMatcher as JOrb
    from mono_slam_framework_tpu.slam import device_io as jdio
    from mono_slam_framework_tpu.utils import prewarm as jpw

    jlog = _record(monkeypatch, jpw, lambda a: [x for x in jax.tree.leaves(a)
                                                if getattr(x, "shape", ()) != ()])
    jdio.prewarm_startup_shapes(JOrb(threshold=0.7, max_features=2000))
    tlog = _record(monkeypatch, device_io, lambda a: [x.spec for x in a])
    device_io.prewarm_startup_shapes(CPU)

    assert len(jlog) == 5
    jgraph = [(n, r[:5] + r[6:]) for n, r in jlog if n == "optimize_pose_graph"]
    assert [r[5] for n, r in jlog if n == "optimize_pose_graph"] == [((128,), "bool"),
                                                                     ((512,), "bool")]
    assert tlog == jgraph and len(tlog) == 2


# ---------------------------------------------------------------------------
# the System with the warm


def _system(world, prewarm_on: bool, max_features: int = 400):
    m = OrbFeatureMatcher(threshold=0.7, max_features=max_features, device="cpu")
    return System(
        SlamParameters(fx=world.f, fy=world.f, cx=world.cx, cy=world.cy,
                       max_features=max_features, minIniMatchCount=100,
                       initializerModelFallback=True, prewarmShapes=prewarm_on),
        m, KeyFrameMatchDatabase(m), verbose=False, device="cpu",
    )


def test_system_starts_the_warm_only_when_asked():
    """A System asks by its own flag: one built with the warm off neither
    queues a warm nor turns the warm off for the process."""
    world = chip_smoke.render_system(chip_smoke.SYSTEM_SMALL._replace(n_warm=1, n_timed=0))[0]
    pw.set_execute(False)  # queue, run nothing
    _system(world, prewarm_on=False)
    assert len(pw._seen) == 0 and pw._enabled is True
    _system(world, prewarm_on=True)
    assert len(pw._seen) == 2  # the graph at both sizes


def test_drive_with_the_warm_is_bit_equal():
    """tests/test_pipeline.py's world, 10 frames, execution pinned: the
    warm runs beside the drive and changes nothing of it."""
    cfg = chip_smoke.SYSTEM_SMALL._replace(n_warm=4, n_timed=6)
    world, poses, images = chip_smoke.render_system(cfg)
    runs = []
    for on in (True, False):
        pw.set_execute(True if on else None)
        with mock.patch.object(device_io, "GRAPH_WARM_SIZES", ((6, 12),)):
            system = _system(world, prewarm_on=on)
            r = chip_smoke.run_system(CPU, cfg, world, poses, images, system=system, flow="fused")
        assert pw.wait(60) and pw.failures() == []
        runs.append((r, len(pw._seen)))
    (on, n_on), (off, n_off) = runs
    assert n_on == 1 and n_off == n_on  # the "off" drive queued nothing
    assert on["states"].count("OK") >= 5
    np.testing.assert_array_equal(on["Tcw"], off["Tcw"])
    assert chip_smoke.pose_checksum(on["system"]) == chip_smoke.pose_checksum(off["system"])


def test_run_parses_prewarm_flags(tmp_path):
    from mono_slam_framework_torch import run
    from mono_slam_framework_torch import slam

    class Stop(Exception):
        pass

    got = []

    def recorder(params, *a, **k):
        got.append(params.prewarmShapes)
        raise Stop

    base = ["--dataset", "tum", "--path", str(tmp_path), "--fx", "500", "--fy", "500",
            "--cx", "320", "--cy", "240", "--device", "cpu", "--quiet"]
    with mock.patch.object(slam, "System", recorder):
        for extra in ([], ["--prewarm"], ["--no-prewarm"]):
            with pytest.raises(Stop):
                run.main(base + extra)
    assert got == [False, True, False]  # off by default


def test_port_imports_no_jax():
    """No module of the port, chip_smoke.py or a tools/torch_* script imports
    jax or the JAX package."""
    files = sorted((ROOT / "mono_slam_framework_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", *sorted((ROOT / "tools").glob("torch_*.py"))]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [(f.name, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "mono_slam_framework_tpu")]
    assert len(files) > 50 and bad == []


def test_graph_solves_in_two_threads_at_once():
    """The warm solves an essential graph beside the loop closer: two threads
    inside optimize_pose_graph at once must both finish, each with the
    result it gets alone (the solver keeps no process-wide state, as
    torch.func's forward-AD levels were)."""
    import sys

    problems = [_off_optimum(5, 8), _off_optimum(7, 12)]
    alone = [optimize_pose_graph(*a, iters=3)[0] for a in problems]
    got, errors = [[], []], []

    def solve(k):
        try:
            for _ in range(6):
                got[k].append(optimize_pose_graph(*problems[k], iters=3)[0])
        except Exception as e:  # recorded: the assertion below reports it
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=solve, args=(k,)) for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    for k in (0, 1):
        assert len(got[k]) == 6 and all(torch.equal(T, alone[k]) for T in got[k])
