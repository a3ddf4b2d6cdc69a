"""What the benchmark takes from the program under test, and nothing else.

The program is `mono_slam_framework_torch`. This module builds its System
from a configuration file, reads the tracker's state and reported pose
after each frame, and reads its counters. It also wraps a few of the
program's public module functions and System methods for the length of a
run, from the benchmark's side:

* `Hooks` records, in a traced run, each launch's shapes of kernels B1
  (`detect.detect_maps[_batch]`) and B2 (`pose_opt.pose_optimize[_batched]`;
  B2's valid-edge mask is kept and counted after the window), the shapes of
  the Hamming distance matrices (`hamming.distance_matrix`) and of the
  LoFTR calls (`loftr_native.encode`: (images, height, width);
  `confidence_from_features`: (pairs, tokens)), which the work files count,
  and a `torch.profiler.record_function` span around each stage call
  (`fused_host.run_steady`, `fused_loftr.run_steady` and the System's
  stages). It also installs the wrappers of the checks a cell's limits
  name (`checks/<name>.py`): on the operations the harness samples they
  keep copies of the inputs and outputs of the program's functions
  (device copies, no synchronization) for the comparison after the window.
  A change to the program that renames these functions or moves the work
  out of them leaves the comparison with nothing to compare, and `correct`
  false.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch

from mono_slam_framework_torch.matchers import LoftrFeatureMatcher, OrbFeatureMatcher
from mono_slam_framework_torch.models import loftr_native
from mono_slam_framework_torch.ops import detect, hamming
from mono_slam_framework_torch.optim import pose_opt
from mono_slam_framework_torch.params import SlamParameters
from mono_slam_framework_torch.slam import KeyFrameMatchDatabase, System, fused_host, fused_loftr
from mono_slam_framework_torch.slam.frame import reset_frame_ids
from mono_slam_framework_torch.slam.map_model import reset_map_ids

OK = "OK"


def weights_path(root, config: dict):
    return None if "weights" not in config else str(root / config["weights"])


def _params(config: dict) -> SlamParameters:
    return SlamParameters(
        fx=config["Camera.fx"], fy=config["Camera.fy"],
        cx=config["Camera.cx"], cy=config["Camera.cy"],
        max_features=config.get("ORBextractor.nFeatures", 512),
        **config.get("params", {}),
    )


def matcher_factory(root, config: dict, device):
    m = config["matcher"]
    if m["kind"] == "orb":
        return lambda: OrbFeatureMatcher(threshold=m["ratio"], max_features=config["ORBextractor.nFeatures"],
                                         fast_threshold=float(config["ORBextractor.iniThFAST"]), device=device)
    if m["kind"] == "loftr":
        path = weights_path(root, config)
        return lambda: LoftrFeatureMatcher(model_path=path, threshold=m["threshold"], fine=m["fine"],
                                           device=device)
    raise ValueError(f"unknown matcher {m['kind']!r}")


def build_system(root, config: dict, device) -> System:
    reset_frame_ids()
    reset_map_ids()
    m = matcher_factory(root, config, device)()
    system = System(_params(config), m, KeyFrameMatchDatabase(m), verbose=False, device=device)
    system.toggle_initialization_allowed()
    return system


def state(system: System) -> str:
    return system.tracker.state.name


def reported_pose(system: System):
    """The pose the tracker reports for the frame it was just fed (None when
    it has none)."""
    frame = system.tracker.current_frame
    return None if frame is None else frame.get_pose()


def reopen_gate(system: System) -> None:
    """Allow initialization again where the tracker has closed its gate (a
    reset after a failed initialization closes it, Tracking.reset; the
    reference app's user opens it with a key)."""
    if (system.tracker.state.name in ("NO_IMAGES_YET", "NOT_INITIALIZED")
            and not system.tracker.initialization_allowed):
        system.toggle_initialization_allowed()


def reset(system: System) -> None:
    system.reset()
    system.toggle_initialization_allowed()


def counters(systems) -> dict:
    """The program's own counters, summed over Systems: the fused flow's
    `pipe_stats` and the System's stage timer totals (s)."""
    out: dict = {}
    for s in systems:
        for k, v in fused_host.pipe_stats(s.tracker).items():
            if isinstance(v, (int, float)):
                out[f"pipe.{k}"] = out.get(f"pipe.{k}", 0) + v
        for k, v in s.timer.totals.items():
            out[f"timer.{k}"] = out.get(f"timer.{k}", 0.0) + v
    return out


class OpView:
    """What one check's wrappers see of the operation under way: whether
    the harness samples it (`sampled`), whether it is one of the sampled
    operations that the costlier captures are taken on (`heavy`: every
    `b1_sample_every`-th of the mix), and what the check has kept on it so
    far (`kept`, a list the wrappers append to)."""

    def __init__(self, hooks: "Hooks", name: str):
        self._hooks, self._name = hooks, name

    @property
    def sampled(self) -> bool:
        return self._hooks.sampling

    @property
    def heavy(self) -> bool:
        return self._hooks.heavy

    @property
    def kept(self) -> list:
        return self._hooks.kept[self._name]


class Hooks:
    """Wraps the program's module functions for one run (see the module
    docstring). `checks` maps each check's name to its module, whose
    `wrappers(op)` gives `{"package.module:function": make}` with
    `make(real) -> wrapped`. `sampling` and `heavy` are set by the harness
    around a sampled operation; `tracing` for the whole traced window."""

    def __init__(self, checks: dict):
        self.checks = checks
        self.sampling = False
        self.heavy = False
        self.tracing = False
        self.kept: dict = {name: [] for name in checks}  # this operation's captures, by check
        self.launch_b1: list = []  # (dims, n_streams) per B1 launch on a card
        self.launch_b2: list = []  # (E, B, valid) per B2 launch on a card
        self.loftr_encodes: list = []  # (images, height, width) per LoFTR encode
        self.loftr_confidences: list = []  # (pairs, tokens) per LoFTR confidence call
        self.hamming_shapes: list = []  # (pairs of sets, K1, K2)
        self.keyframes_created = 0
        self._undo: list = []

    # -- installation ------------------------------------------------------
    def _patch(self, owner, name, make):
        real = getattr(owner, name)
        setattr(owner, name, make(real))
        self._undo.append((owner, name, real))

    def install(self, systems) -> None:
        self._patch(pose_opt, "pose_optimize", self._pose(batched=False))
        self._patch(pose_opt, "pose_optimize_batched", self._pose(batched=True))
        self._patch(detect, "detect_maps", self._detect(batched=False))
        self._patch(detect, "detect_maps_batch", self._detect(batched=True))
        self._patch(loftr_native, "confidence_from_features", self._confidence)
        self._patch(loftr_native, "encode", self._encode)
        self._patch(hamming, "distance_matrix", self._hamming)
        self._patch(fused_host, "run_steady", self._span("fused.run_steady"))
        self._patch(fused_loftr, "run_steady", self._span("fused_loftr.run_steady"))
        for s in systems:
            self._patch(s.tracker, "grab_image_monocular", self._span("tracking"))
            self._patch(s.tracker, "create_new_keyframe", self._new_keyframe)
            self._patch(s.local_mapper, "run", self._span("local_mapping"))
            self._patch(s.loop_closer, "run", self._span("loop_closing"))
            self._patch(s.map_drawer, "update", self._span("map_drawer"))
        for name, check in self.checks.items():
            for target, make in check.wrappers(OpView(self, name)).items():
                module, function = target.split(":")
                self._patch(importlib.import_module(module), function, make)

    def uninstall(self) -> None:
        for owner, name, real in reversed(self._undo):
            setattr(owner, name, real)
        self._undo.clear()

    # -- per operation -------------------------------------------------------
    def begin(self, sampled: bool, heavy: bool) -> None:
        self.sampling, self.heavy = sampled, heavy
        self.kept = {name: [] for name in self.checks}

    def end(self) -> dict:
        self.sampling = False
        return self.kept

    # -- wrappers ------------------------------------------------------------
    def _span(self, name):
        def make(real):
            def wrapped(*a, **k):
                if not self.tracing:
                    return real(*a, **k)
                with torch.profiler.record_function(f"slam_bench.{name}"):
                    return real(*a, **k)
            return wrapped
        return make

    def _new_keyframe(self, real):
        def wrapped(*a, **k):
            self.keyframes_created += 1
            return real(*a, **k)
        return wrapped

    def _pose(self, batched: bool):
        def make(real):
            def wrapped(T_init, Xw, uv, valid, K, info=None):
                out = real(T_init, Xw, uv, valid, K, info)
                if self.tracing and Xw.is_cuda:
                    self.launch_b2.append((Xw.shape[-2], Xw.shape[0] if batched else 1, valid))
                return out
            return wrapped
        return make

    def _detect(self, batched: bool):
        def make(real):
            def wrapped(stack, dims, threshold=20.0, border=31):
                maps = real(stack, dims, threshold, border)
                if self.tracing and stack.is_cuda:
                    self.launch_b1.append((tuple(tuple(int(v) for v in d) for d in dims),
                                           stack.shape[0] if batched else 1))
                return maps
            return wrapped
        return make

    def _confidence(self, real):
        def wrapped(model, f0, f1):
            if self.tracing:
                self.loftr_confidences.append((int(f0.shape[0]), int(f0.shape[1])))
            return real(model, f0, f1)
        return wrapped

    def _encode(self, real):
        def wrapped(model, img):
            if self.tracing:
                self.loftr_encodes.append((int(img.shape[0]), int(img.shape[-2]), int(img.shape[-1])))
            return real(model, img)
        return wrapped

    def _hamming(self, real):
        def wrapped(desc1, desc2, valid1, valid2):
            d = real(desc1, desc2, valid1, valid2)
            if self.tracing and d.is_cuda:
                k1, k2 = d.shape[-2], d.shape[-1]
                self.hamming_shapes.append((int(np.prod(d.shape[:-2])) if d.dim() > 2 else 1, k1, k2))
            return d
        return wrapped


@contextlib.contextmanager
def installed(hooks: Hooks, systems):
    hooks.install(systems)
    try:
        yield hooks
    finally:
        hooks.uninstall()
