"""Loop closing: match-database loop detection.

PyTorch counterpart of `mono_slam_framework_tpu/slam/loop_closing.py`
(the reference LoopClosing, include/LoopClosing.h, src/LoopClosing.cc),
detection only: `run` drains one keyframe, applies the cooldown and asks the
keyframe database for a candidate (one batched matcher call). A detected
loop reaches `correct_loop`, which is not ported yet (Sim(3)
pre-alignment, essential graph, fuse and loop global BA: ROADMAP §A) and
raises.
"""

from __future__ import annotations


class LoopClosing:
    def __init__(self, map_, kf_db, feature_matcher, params, verbose: bool = True):
        self.map = map_
        self.kf_db = kf_db
        self.matcher = feature_matcher
        self.loop_detection_max_frames = params.loopDetectionMaxFrames
        self.min_num_mp_matches = params.minNumMPMatches
        self.queue: list = []
        self.last_loop_kf_id = 0
        self.current_kf = None
        self.matched_kf = None
        self.local_mapper = None
        self.verbose = verbose

    def _log(self, *a):
        if self.verbose:
            print(*a)

    def set_local_mapper(self, lm) -> None:
        self.local_mapper = lm

    def insert_keyframe(self, kf) -> None:
        if kf.id != self.map.origin_kf_id():
            self.queue.append(kf)

    def check_new_keyframes(self) -> bool:
        return bool(self.queue)

    def reset(self) -> None:
        self.queue.clear()
        self.last_loop_kf_id = 0

    # ------------------------------------------------------------------
    def run(self) -> None:
        """One drain-one-keyframe step (LoopClosing::Run, 50-59)."""
        if self.check_new_keyframes():
            if self.detect_loop():
                self.correct_loop()

    def detect_loop(self) -> bool:
        """LoopClosing.cc:69-99: cooldown, then batched DB scan."""
        self.current_kf = self.queue.pop(0)
        self.current_kf.set_not_erase()

        if self.current_kf.id < self.last_loop_kf_id + self.loop_detection_max_frames:
            self.kf_db.add(self.current_kf)
            self.current_kf.set_erase()
            return False

        candidate = self.kf_db.detect_loop_candidate(
            self.current_kf, self.min_num_mp_matches
        )
        if candidate is None:
            self.kf_db.add(self.current_kf)
            self.current_kf.set_erase()
            return False

        self.matched_kf = candidate
        self.current_kf.set_erase()
        return True

    def correct_loop(self) -> None:
        """LoopClosing.cc:101-115 and the JAX package's Sim(3) / fuse /
        global-BA correction: not ported yet."""
        raise NotImplementedError("loop correction: ROADMAP §A")
