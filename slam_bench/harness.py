"""One run of one cell: set-up, the measured window, the traced reading, the
comparison that decides `correct`, and the result.

The harness owns the clock, the window, the synchronization after each
operation and the trace. A traffic mix (`traffic/<name>.json`) is data
that `Traffic` reads: the camera path, the world, how many streams, how many
frames set-up drives, and which driver feeds the program. A driver
(`drivers/<name>.py`, found by the mix's `"driver"`) is an entry point of
the program fed one operation at a time: `system` feeds one `System` one
frame per operation through `track_monocular`.

An operation fails if it raises; a frame also fails if its stream had been
initialized since its last reset and the frame leaves the tracker not OK.
Every tracked frame's reported pose is kept, with the rendered pose it was
drawn from: the window's trajectory error is reported beside the result.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from slam_bench import compare, manifest, trace, world
from slam_bench.reference import loftr as ref_loftr

T_IMPORT = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module
    was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def _deep_update(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _deep_update(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Traffic:
    """The frames of a traffic mix, rendered on the device from the seed and
    kept as host arrays, as a camera or a loader hands them over."""

    def __init__(self, spec: dict, config: dict, seed: int, device):
        self.spec = spec
        self.n = spec["frames"]
        self.streams = spec.get("streams", 1)
        self.fps = config["Camera.fps"]
        x, y = world.path_centres(spec["path"], self.n)
        poses = world.translation_poses(x, y)
        w = spec["world"]
        planes = [tuple(p) for p in w.get("planes", [])]
        if "bands" in w:
            b = w["bands"]
            count = int((b["stop"] - b["start"]) / b["spacing"]) + 1
            planes += [(b["depths"][k % len(b["depths"])], b["start"] + k * b["spacing"], "x")
                       for k in range(count)]
        tex = w["texture"]
        self.poses, self.frames = [], []
        world_seed = seed if w.get("seed") is None else w["seed"]
        for s in range(self.streams):
            texture = world.kron_texture(world.rng_for(world_seed, 1, s), tex["size"], tex["squares"])
            wd = world.World(config["image_width"], config["image_height"], config["Camera.fx"],
                             config["Camera.fy"], config["Camera.cx"], config["Camera.cy"],
                             w["plane_z"], planes, texture, tex["scale"], device)
            order = (np.arange(self.n) + s * spec.get("stream_offset", 0)) % self.n
            self.poses.append(poses[order])
            self.frames.append(wd.render_host(poses[order]))
            del wd
        if device.type == "cuda":
            torch.cuda.empty_cache()

    def image(self, stream: int, i: int) -> np.ndarray:
        return self.frames[stream][i % self.n]

    def pose(self, stream: int, i: int) -> np.ndarray:
        """The world->camera pose frame `i` of `stream` was rendered from."""
        return self.poses[stream][i % self.n]


@dataclass
class Run:
    """What a per-layer reader (metrics/<name>.py) is given."""

    frames: int
    ops: int
    window_s: float
    counters: dict  # the program's counters over the window (port.counters)
    hooks: object  # port.Hooks: launch shapes, LoFTR calls, Hamming shapes, keyframes
    trace: trace.TraceSummary | None
    b2_valid: list = field(default_factory=list)  # valid edges per B2 launch


@dataclass
class Outcome:
    result: dict
    numbers: dict
    limits: dict
    control: dict
    info: dict


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device,
             bench: dict | None = None, overrides: dict | None = None,
             control: bool = False, fault=None) -> Outcome:
    """One run of `cell` (a `workloads` entry). `overrides` replace entries
    of the configuration, traffic and limits files ({"config": {...},
    "traffic": {...}, "limits": {...}}: the CPU tests' small sizes);
    `fault(driver)` is a context manager that breaks the program under the
    window (the fault tests);
    `control` also reads every comparison with the reference one precision
    lower in the program's place."""
    from slam_bench import port

    bench = bench or manifest.load_manifest()
    overrides = overrides or {}
    config = _deep_update(manifest.load_json(manifest.config_file(cell["config"])), overrides.get("config"))
    spec = _deep_update(manifest.load_json(manifest.traffic_file(cell["traffic"])), overrides.get("traffic"))
    limits = _deep_update(manifest.load_json(manifest.limits_file(cell["name"])), overrides.get("limits"))
    # the cell's limits name its checks: pose, b1, ham, conf
    checks = [c for c in compare.CHECKS if f"{c}_checked" in limits]
    traffic = Traffic(spec, config, seed, device)
    driver = manifest.driver_class(spec["driver"])(manifest.ROOT, config, traffic, device)
    hooks = port.Hooks(capture_b1="b1" in checks, capture_ham="ham" in checks,
                       capture_conf="conf" in checks)
    initialized = [False] * traffic.streams
    # (stream, reset count, reported pose, rendered pose) of each frame of
    # the window the tracker reports as tracked
    track: list = []

    def after_op(before: list, i: int, keep: bool, window: bool):
        frames, failed = [], 0
        for s, system in enumerate(driver.systems):
            if before[s] in ("NO_IMAGES_YET",):
                initialized[s] = False
            port.reopen_gate(system)
            after = port.state(system)
            if after == port.OK:
                initialized[s] = True
            elif initialized[s]:
                failed += 1
            if keep or (window and after == port.OK):
                pose = port.reported_pose(system)
                if keep:
                    frames.append((s, before[s], after, pose))
                if window and after == port.OK and before[s] in compare.TRACKED_FROM:
                    track.append((s, driver.resets, pose, traffic.pose(s, i)))
        return frames, failed

    with port.installed(hooks, driver.systems):
        for i in range(spec["setup_frames"]):
            after_op(driver.op(i), i, False, False)
            _sync(device)
        sampler = world.rng_for(seed, 2)
        every = spec.get("sample_every", 16)
        b1_every = spec.get("b1_sample_every", 4)
        records: list = []
        frame_ms: list = []
        attempted = failed = raised = ops = 0
        errors: list = []
        c0 = port.counters(driver.systems)
        hooks.keyframes_created = 0
        prof = None
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            hooks.tracing = True
        with (fault(driver) if fault is not None else contextlib.nullcontext()):
            setup_s = process_age_s()
            i = spec["setup_frames"]
            n_sampled = 0
            with torch.profiler.record_function(trace.WINDOW_SPAN):
                t0 = time.perf_counter()
                while True:
                    sampled = sampler.random() < 1.0 / every
                    hooks.begin(sampled, sampled and n_sampled % b1_every == 0)
                    n_frames = traffic.streams
                    t_op = time.perf_counter()
                    try:
                        before = driver.op(i)
                        _sync(device)
                        op_failed = None
                    except Exception as exc:  # an operation that raises is a failed one
                        _sync(device)
                        op_failed = exc
                        errors.append(repr(exc)[:300])
                    t_end = time.perf_counter()
                    solves, b1, ham, conf = hooks.end()
                    frame_ms.extend([(t_end - t_op) * 1e3] * n_frames)
                    attempted += n_frames
                    if op_failed is not None:
                        failed += n_frames
                        raised += n_frames
                    else:
                        frames, f = after_op(before, i, sampled, True)
                        failed += f
                        if sampled:
                            n_sampled += 1
                            records.append({
                                "op": i, "frames": frames, "solves": solves, "b1": b1, "ham": ham,
                                "conf": conf,
                                "conf_images": (traffic.image(0, i), traffic.image(0, i - 1)) if conf else None,
                            })
                    ops += 1
                    i += 1
                    if t_end - t0 >= seconds:
                        break
                window_s = t_end - t0
        hooks.tracing = False
        if prof is not None:
            prof.__exit__(None, None, None)
        c1 = port.counters(driver.systems)
        memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        b2_valid = [int(v.sum()) for _, _, v in hooks.launch_b2]
    t_read = time.perf_counter()
    summary = trace.summarize(prof) if prof is not None else None
    t_read = time.perf_counter() - t_read
    prof = None
    counters = {k: c1.get(k, 0) - c0.get(k, 0) for k in c1}
    frames_done = attempted - raised
    run = Run(frames=attempted, ops=ops, window_s=window_s, counters=counters, hooks=hooks,
              trace=summary, b2_valid=b2_valid)
    info = {"ops": ops, "resets": driver.resets, "sampled_ops": len(records),
            "keyframes_created": hooks.keyframes_created,
            "fused_steady": counters.get("pipe.done_steady", 0), "first_op": spec["setup_frames"],
            "trace_read_s": t_read, "errors": len(errors), "first_error": errors[0] if errors else None}
    del driver
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    weights = None
    if "conf" in checks:
        weights = ref_loftr.load_weights(manifest.ROOT / config["weights"], device)
    t_judge = time.perf_counter()
    numbers, ctrl = compare.judge(records, checks, weights, control)
    info.update(compare.judge_ate(track))
    # a frame left not OK after its stream had initialized is a lost answer
    numbers["frames_lost"] = failed
    info["judge_s"] = time.perf_counter() - t_judge
    limits = {k: v for k, v in limits.items() if k in numbers}
    correct = all(k in limits and compare.within(v, limits[k]) for k, v in numbers.items())

    e2e = {
        "frames_per_s": {"value": frames_done / window_s, "unit": "frames/s"},
        "frame_ms_p50": {"value": float(np.percentile(frame_ms, 50)), "unit": "ms"},
        "frame_ms_p95": {"value": float(np.percentile(frame_ms, 95)), "unit": "ms"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }
    name = cell["name"]
    if traced:
        metrics = {}
        for m in manifest.metrics_for(bench, name, "per_layer"):
            v = manifest.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: e2e[m["name"]] for m in manifest.metrics_for(bench, name, "end_to_end")
                   if m["name"] in e2e}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.top_device_ops(),
                               "idle_gaps": summary.idle_by_host}
    info["e2e"] = {k: v["value"] for k, v in e2e.items()}
    # the window's frame times in fifths, to tell a slow host from a slow phase
    fifths = np.array_split(np.asarray(frame_ms), 5)
    info["frame_ms_mean_by_fifth"] = [float(f.mean()) for f in fifths if len(f)]
    result["checks"] = {k: {"value": v, "limit": compare.limit_text(limits[k]) if k in limits else "unset"}
                        for k, v in numbers.items()}
    return Outcome(result, numbers, limits, ctrl, info)
