"""What the benchmark takes from the program under test, and nothing else.

The program is `mono_slam_framework_torch`. This module builds its System
from a configuration file, reads the tracker's state and reported pose
after each frame, and reads its counters. It also wraps a few of the
program's public module functions and System methods for the length of a
run, from the benchmark's side:

* `Hooks` sees every pose LM (`pose_opt.pose_optimize[_batched]`, kernel B2
  on a card), detection (`detect.detect_maps[_batch]`, kernel B1), Hamming
  distance matrix (`hamming.distance_matrix`), LoFTR confidence and encode
  (`loftr_native.confidence_from_features`, `encode`) and fused steady step
  (`fused_host.run_steady`, `fused_loftr.run_steady`). On the operations
  the harness samples it keeps copies of the inputs and outputs (device
  copies, no synchronization) for the comparison after the window; in a
  traced run it also records each launch's shapes (B2's valid-edge mask is
  kept and counted after the window), the LoFTR calls' batch sizes, and a
  `torch.profiler.record_function` span around each stage call. A change
  to the program that renames these functions or moves the work out of
  them leaves the comparison with nothing to compare, and `correct` false.
"""

from __future__ import annotations

import contextlib

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
# the Hamming answers kept on a sampled operation: its first HAM_CALLS
# matrices, every 16th query row of each
HAM_CALLS = 2
HAM_ROWS = slice(None, None, 16)


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


def _clone(x):
    return None if x is None else x.detach().clone()


class Hooks:
    """Wraps the program's module functions for one run (see the module
    docstring). `sampling` is set by the harness around a sampled
    operation; `tracing` for the whole traced window."""

    def __init__(self, capture_b1: bool, capture_ham: bool, capture_conf: bool):
        self.capture_b1 = capture_b1
        self.capture_ham = capture_ham
        self.capture_conf = capture_conf
        self.sampling = False
        self.take_b1 = False
        self.tracing = False
        self.solves: list = []  # this operation's pose LMs: (inputs, outputs)
        self.b1: list = []  # this operation's detections: (stack, dims, threshold, border, maps)
        self.ham: list = []  # this operation's Hamming matrices: (desc1, desc2, valid1, valid2, d) on HAM_ROWS
        self.conf: list = []  # this operation's motion-phase LoFTR confidences
        self.in_loftr_steady = False
        self.launch_b1: list = []  # (dims, n_streams) per B1 launch on a card
        self.launch_b2: list = []  # (E, B, valid) per B2 launch on a card
        self.loftr_encode_images = 0
        self.loftr_pairs = 0
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
        self._patch(fused_loftr, "run_steady", self._loftr_steady)
        for s in systems:
            self._patch(s.tracker, "grab_image_monocular", self._span("tracking"))
            self._patch(s.tracker, "create_new_keyframe", self._new_keyframe)
            self._patch(s.local_mapper, "run", self._span("local_mapping"))
            self._patch(s.loop_closer, "run", self._span("loop_closing"))
            self._patch(s.map_drawer, "update", self._span("map_drawer"))

    def uninstall(self) -> None:
        for owner, name, real in reversed(self._undo):
            setattr(owner, name, real)
        self._undo.clear()

    # -- per operation -------------------------------------------------------
    def begin(self, sampled: bool, take_b1: bool) -> None:
        self.sampling, self.take_b1 = sampled, take_b1
        self.solves, self.b1, self.ham, self.conf = [], [], [], []

    def end(self) -> tuple:
        self.sampling = False
        return self.solves, self.b1, self.ham, self.conf

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
                if self.sampling:
                    args = (T_init, Xw, uv, valid, K, info)
                    if not batched:
                        args = tuple(None if a is None else a[None] for a in args)
                        res = tuple(o[None] for o in out)
                    else:
                        res = out
                    self.solves.append((tuple(_clone(a) for a in args), tuple(_clone(o) for o in res)))
                if self.tracing and Xw.is_cuda:
                    self.launch_b2.append((Xw.shape[-2], Xw.shape[0] if batched else 1, valid))
                return out
            return wrapped
        return make

    def _detect(self, batched: bool):
        def make(real):
            def wrapped(stack, dims, threshold=20.0, border=31):
                maps = real(stack, dims, threshold, border)
                if self.sampling and self.take_b1 and self.capture_b1:
                    s = stack if batched else stack[None]
                    m = tuple(x if batched else x[None] for x in maps)
                    self.b1.append((_clone(s), tuple(tuple(d) for d in dims), float(threshold),
                                    int(border), tuple(_clone(x) for x in m)))
                if self.tracing and stack.is_cuda:
                    self.launch_b1.append((tuple(tuple(int(v) for v in d) for d in dims),
                                           stack.shape[0] if batched else 1))
                return maps
            return wrapped
        return make

    def _loftr_steady(self, real):
        span = self._span("fused_loftr.run_steady")(real)

        def wrapped(*a, **k):
            self.in_loftr_steady = True
            try:
                return span(*a, **k)
            finally:
                self.in_loftr_steady = False
        return wrapped

    def _confidence(self, real):
        def wrapped(model, f0, f1):
            conf = real(model, f0, f1)
            if self.tracing:
                self.loftr_pairs += f0.shape[0]
            # the first single-pair confidence of a steady frame is its
            # motion phase: the current frame against the last one
            if (self.sampling and self.capture_conf and self.in_loftr_steady
                    and f0.shape[0] == 1 and not self.conf):
                self.conf.append(_clone(conf[0]))
            return conf
        return wrapped

    def _encode(self, real):
        def wrapped(model, img):
            if self.tracing:
                self.loftr_encode_images += img.shape[0]
            return real(model, img)
        return wrapped

    def _hamming(self, real):
        def wrapped(desc1, desc2, valid1, valid2):
            d = real(desc1, desc2, valid1, valid2)
            if self.sampling and self.take_b1 and self.capture_ham and len(self.ham) < HAM_CALLS:
                self.ham.append((_clone(desc1[..., HAM_ROWS, :]), _clone(desc2),
                                 _clone(valid1[..., HAM_ROWS]), _clone(valid2), _clone(d[..., HAM_ROWS, :])))
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
