"""Application-layer helpers mirroring the reference Webots controller.

A copy of `mono_slam_framework_tpu/utils/app.py` (numpy and threading).

  * GammaCorrector — the LUT-based gamma correction the reference applies to
    camera frames before tracking (src/main.cpp:21-39);
  * AsyncSlamDriver — the reference's std::async tracking step: TrackMonocular
    runs off the caller's loop and new frames are DROPPED while a step is in
    flight (src/main.cpp:108, 131-140), keeping the control loop real-time.
"""

from __future__ import annotations

import threading

import numpy as np


class GammaCorrector:
    """256-entry gamma LUT applied to uint8-range grayscale images."""

    def __init__(self, gamma: float = 1.0):
        self.set_gamma(gamma)

    def set_gamma(self, gamma: float) -> None:
        self.gamma = float(gamma)
        x = np.arange(256, dtype=np.float64) / 255.0
        self._lut = (np.power(x, self.gamma) * 255.0).astype(np.float32)

    def __call__(self, image) -> np.ndarray:
        idx = np.clip(np.asarray(image), 0, 255).astype(np.uint8)
        return self._lut[idx]


class AsyncSlamDriver:
    """Run System.track_monocular on a worker thread; drop frames while busy.

    feed() returns True if the frame was accepted, False if dropped (the
    reference's future-valid check, main.cpp:131-140). close() joins the
    worker after the in-flight step completes.
    """

    def __init__(self, system, track_fn=None):
        """`track_fn` overrides the tracked call (default
        system.track_monocular) — e.g. System.track_monocular_pipelined for
        the dispatch-ahead mode under the same drop-when-busy contract."""
        self.system = system
        self._track = track_fn or system.track_monocular
        self._busy = threading.Event()
        self._thread: threading.Thread | None = None
        self.frames_in = 0
        self.frames_dropped = 0

    def feed(self, image, timestamp: float) -> bool:
        self.frames_in += 1
        if self._busy.is_set():
            self.frames_dropped += 1
            return False
        self._busy.set()

        def work():
            try:
                self._track(image, timestamp)
            finally:
                self._busy.clear()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def wait(self) -> None:
        t = self._thread
        if t is not None:
            t.join()

    def close(self) -> None:
        self.wait()
