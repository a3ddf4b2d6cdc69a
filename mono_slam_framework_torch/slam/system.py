"""System facade: the public API of the framework.

PyTorch counterpart of `mono_slam_framework_tpu/slam/system.py` (the
reference System, slam_pipeline/include/System.h:43-107, src/System.cc): the
host application composes a FeatureMatcher, a KeyFrameDatabase and frame
factories, then drives TrackMonocular per frame. The per-frame superloop is
sequential by design (reference difference #4): tracker ->
LocalMapping.run() -> LoopClosing.run() (System.cc:63-75).

Every device op runs on the System's `device` (the card unless the caller
asks for the CPU); the matcher must extract on the same device. Tracking
runs the default fused flow (`fusedTracking=True`, `fusedOneStep=True`:
slam/fused_host.py) or the reference-twin flow (`fusedTracking=False`);
`track_monocular_pipelined` overlaps each frame's device work with the
caller's next frame, with either matcher (ORB: slam/fused_host.py; LoFTR:
slam/fused_loftr.py). A lost track relocalizes (EPnP over the keyframe
database) and a detected loop is corrected (Sim(3) pre-alignment, essential
graph, fuse, loop global BA), both on the System's device. As in the JAX
package, the System always builds a map drawer and the tracker updates it
on every OK frame; `start_gui` starts its viewer thread. Checkpoints keep
the JAX package's .npz layout (io/checkpoint.py). With
`SlamParameters.prewarmShapes` (off by default) a System on a card solves an
essential graph in a background thread at construction, so that its first
loop correction finds the solve's one-time set-up paid
(device_io.prewarm_startup_shapes).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mono_slam_framework_torch import device as device_mod
from mono_slam_framework_torch.geometry import se3
from mono_slam_framework_torch.slam import device_io, fused_host
from mono_slam_framework_torch.slam.frame import FrameFactory
from mono_slam_framework_torch.slam.local_mapping import LocalMapping
from mono_slam_framework_torch.slam.loop_closing import LoopClosing
from mono_slam_framework_torch.slam.map_model import KeyFrameFactory, Map
from mono_slam_framework_torch.slam.tracking import Tracking
from mono_slam_framework_torch.utils.profiling import StageTimer
from mono_slam_framework_torch.viz.map_drawer import MapDrawer


def _quaternion(Rwc: np.ndarray) -> np.ndarray:
    return se3.rotation_to_quaternion(torch.from_numpy(np.asarray(Rwc))).numpy()


class System:
    def __init__(
        self,
        parameters,
        feature_matcher,
        keyframe_database,
        frame_factory: FrameFactory | None = None,
        keyframe_factory: KeyFrameFactory | None = None,
        verbose: bool = True,
        rng_seed: int = 0,
        device: torch.device | str = device_mod.DEFAULT,
    ):
        self.device = device_mod.resolve(device)
        matcher_device = getattr(feature_matcher, "device", None)
        if matcher_device is not None and torch.device(matcher_device) != self.device:
            raise ValueError(
                f"the matcher extracts on {matcher_device}, the System runs on "
                f"{self.device}; give both the same device"
            )
        self.params = parameters
        self.verbose = verbose
        self.matcher = feature_matcher
        self.kf_db = keyframe_database
        frame_factory = frame_factory or FrameFactory()
        keyframe_factory = keyframe_factory or KeyFrameFactory()

        self.map = Map()
        self.map_drawer = MapDrawer(self.map)
        self.tracker = Tracking(
            self.map_drawer,
            self.map,
            self.kf_db,
            parameters,
            feature_matcher,
            frame_factory,
            keyframe_factory,
            verbose=verbose,
            rng_seed=rng_seed,
            device=self.device,
        )
        self.local_mapper = LocalMapping(
            self.map, feature_matcher, parameters, self.device, verbose=verbose
        )
        self.loop_closer = LoopClosing(
            self.map, self.kf_db, feature_matcher, parameters, self.device,
            verbose=verbose,
        )
        self.tracker.local_mapper = self.local_mapper
        self.tracker.loop_closer = self.loop_closer
        self.local_mapper.set_loop_closer(self.loop_closer)
        self.loop_closer.set_local_mapper(self.local_mapper)

        if parameters.prewarmShapes:
            # the first loop correction's solve, in the background (a no-op
            # on the CPU: utils/prewarm.py)
            device_io.prewarm_startup_shapes(self.device)

        self._current_position: np.ndarray | None = None
        self._big_change_seen = 0
        # per-stage wall-clock accumulators, named after the reference's
        # modules
        self.timer = StageTimer()

    # ------------------------------------------------------------------
    def track_monocular(self, image, timestamp: float) -> None:
        """Per-frame sequential superloop (System.cc:63-75)."""
        with self.timer.stage("tracking"):
            tcw = self.tracker.grab_image_monocular(image, timestamp)
        with self.timer.stage("local_mapping"):
            self.local_mapper.run()
        with self.timer.stage("loop_closing"):
            self.loop_closer.run()
        self._current_position = tcw

    def track_monocular_pipelined(self, image, timestamp: float):
        """Throughput mode (requires `fusedOneStep`): processes the PREVIOUS
        frame and speculatively dispatches THIS frame's steady step from the
        last frame's device-resident chain state
        (fused_host.dispatch_steady_spec): the device work and its copy to
        the host overlap the caller's next-frame time, so steady frames cost
        roughly the host replay alone. One-frame latency: returns the
        previous frame's `last_metrics` (None on the first call);
        poses/maps reflect the last COMPLETED frame. Call `flush_pipeline()`
        after the final frame.
        """
        out = None
        prev = getattr(self, "_pipe_prev", None)
        t0 = time.perf_counter()
        if prev is not None:
            self.track_monocular(*prev)
            out = self.last_metrics
        t1 = time.perf_counter()
        self._pipe_prev = (image, timestamp)
        self.tracker._pipe_spec = fused_host.dispatch_steady_spec(self.tracker, image)
        # per-call samples: process_ms = the previous frame's processing,
        # dispatch_ms = the host cost of queueing the next frame's step
        s = fused_host.pipe_stats(self.tracker)
        s.setdefault("process_samples_ms", []).append((t1 - t0) * 1e3)
        s.setdefault("dispatch_samples_ms", []).append((time.perf_counter() - t1) * 1e3)
        return out

    def flush_pipeline(self):
        """Complete the pending pipelined frame (if any)."""
        prev = getattr(self, "_pipe_prev", None)
        self._pipe_prev = None
        self.tracker._pipe_spec = None
        if prev is not None:
            self.track_monocular(*prev)
            return self.last_metrics
        return None

    def map_changed(self) -> bool:
        """Big-change polling (System.cc:77-85)."""
        cur = self.map.get_last_big_change_idx()
        if self._big_change_seen < cur:
            self._big_change_seen = cur
            return True
        return False

    def reset(self) -> None:
        self.tracker.reset()

    def save_keyframe_trajectory_tum(self, filename: str) -> None:
        """TUM-format export `t x y z qx qy qz qw` (System.cc:89-122,
        quaternion order per Converter.cc:113-124)."""
        if self.verbose:
            print(f"\nSaving keyframe trajectory to {filename} ...")
        kfs = sorted(self.map.all_keyframes(), key=lambda kf: kf.id)
        with open(filename, "w") as f:
            for kf in kfs:
                if kf.is_bad:
                    continue
                q = _quaternion(kf.get_rotation_inverse())
                t = kf.get_camera_center()
                f.write(
                    f"{kf.timestamp:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
                )
        if self.verbose:
            print("\ntrajectory saved!")

    def save_trajectory_tum(self, filename: str) -> None:
        """Full per-frame trajectory export (upstream ORB-SLAM2's
        SaveTrajectoryTUM). Each frame's pose is re-anchored on its reference
        keyframe's CURRENT pose (Tcw = Tcr * Tref), walking up the spanning
        tree through culled keyframes via their stored Tcp."""
        tr = self.tracker
        with open(filename, "w") as f:
            for tcr, ref, ts, lost in zip(
                tr.relative_frame_poses, tr.references, tr.frame_times, tr.lost_flags
            ):
                if lost or ref is None:
                    continue
                trw = np.eye(4, dtype=np.float32)
                kf = ref
                while kf.is_bad and kf.parent is not None and kf.Tcp is not None:
                    trw = trw @ kf.Tcp
                    kf = kf.parent
                if kf.Tcw is None:
                    continue
                tcw = tcr @ trw @ kf.Tcw
                Rwc = tcw[:3, :3].T
                q = _quaternion(Rwc)
                t = -Rwc @ tcw[:3, 3]
                f.write(
                    f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
                )

    def start_gui(
        self,
        out_path: str | None = None,
        interval: float = 1.0,
        http_port: int | None = None,
    ) -> None:
        """Start map drawing + the live viewer thread (System::StartGUI twin;
        the headless 'window' is a rolling PNG and an optional HTTP endpoint,
        see viz/map_drawer.py)."""
        self.map_drawer.start()
        self.map_drawer.start_viewer(out_path, interval, http_port)

    def stop_gui(self) -> None:
        self.map_drawer.stop()

    def set_minimum_keyframes(self, n: int) -> None:
        self.tracker.set_minimum_keyframes(n)

    def get_current_position(self):
        return self._current_position

    def get_all_map_points(self):
        return self.map.all_map_points()

    def get_current_match_image(self):
        return self.tracker.get_current_match_image()

    def toggle_initialization_allowed(self) -> None:
        self.tracker.toggle_initialization_allowed()

    @property
    def last_metrics(self) -> dict:
        """Structured per-frame metrics (SURVEY.md §5 observability)."""
        return self.tracker.last_metrics

    def save_checkpoint(self, path: str) -> None:
        """Full-map snapshot (io/checkpoint.py; the reference exports only a
        trajectory)."""
        from mono_slam_framework_torch.io import checkpoint

        checkpoint.save_map(path, self.map)

    def load_checkpoint(self, path: str) -> None:
        from mono_slam_framework_torch.io import checkpoint

        checkpoint.load_map(path, self.map, self.kf_db, self.params)
