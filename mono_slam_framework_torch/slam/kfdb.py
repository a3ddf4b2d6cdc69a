"""Keyframe match database — place recognition without bag-of-words.

A copy of `mono_slam_framework_tpu/slam/kfdb.py` (host-side Python over the
matcher's batched `match_against_many`).

Capability twin of KeyFrameMatchDatabase (slam_pipeline/include/KeyFrameDatabase.h,
src/KeyFrameDatabase.cc): loop candidates and relocalization candidates are
found by matching the query frame against every stored keyframe.

Design: the reference's O(N) serial scan — one FeatureMatcher::MatchFrames
call per stored KF (KeyFrameDatabase.cc:31-33, 63-70) — becomes ONE batched
matcher call over the stacked per-KF features (`match_against_many`). This is
the single biggest algorithmic win of the rebuild (SURVEY.md §5
"long-context" row): place recognition cost goes from N serial matcher runs
to one device program.
"""

from __future__ import annotations

import abc


class KeyFrameDatabase(abc.ABC):
    """Abstract DB contract (include/KeyFrameDatabase.h:14-29)."""

    @abc.abstractmethod
    def add(self, kf):
        ...

    @abc.abstractmethod
    def erase(self, kf):
        ...

    @abc.abstractmethod
    def clear(self):
        ...

    @abc.abstractmethod
    def detect_loop_candidate(self, kf, min_num_mp_matches: int):
        ...

    @abc.abstractmethod
    def detect_relocalization_candidates(self, frame):
        ...


class KeyFrameMatchDatabase(KeyFrameDatabase):
    def __init__(self, feature_matcher):
        self.matcher = feature_matcher
        self.frames: list = []

    def add(self, kf) -> None:
        self.frames.append(kf)

    def erase(self, kf) -> None:
        try:
            self.frames.remove(kf)
        except ValueError:
            pass

    def clear(self) -> None:
        self.frames.clear()

    def detect_loop_candidate(self, kf, min_num_mp_matches: int):
        """Best non-connected stored KF by count of matches whose BOTH pixels
        already map to MapPoints; must exceed min_num_mp_matches (strict '>',
        reference quirk B7, KeyFrameDatabase.cc:44).
        """
        if not self.frames:
            return None
        connected = kf.get_connected_keyframes()
        results = self.matcher.match_against_many(kf, self.frames)
        best, best_num = None, 0
        for kfi, res in zip(self.frames, results):
            # num_mp <= num_matches, so targets at or under the strict '>'
            # threshold can never win — skip their per-match map lookups
            # (the Python walk over every target's matches dominated the
            # scan cost at 2000 features)
            if res.num_matches <= min_num_mp_matches or kfi in connected:
                continue
            num_mp = 0
            for i in range(res.num_matches):
                if res.get_map_point1(i) is not None and res.get_map_point2(i) is not None:
                    num_mp += 1
            if num_mp > min_num_mp_matches and num_mp > best_num:
                best, best_num = kfi, num_mp
        return best

    def detect_relocalization_candidates(self, frame):
        """Full-scan scoring with covisibility accumulation
        (KeyFrameDatabase.cc:55-117): keep KFs with >= 0.8*max matches,
        accumulate scores over their 10 best covisibles, return the best KF
        of each group when its accumulated score > 0.75*best.
        """
        if not self.frames:
            return []
        results = self.matcher.match_against_many(frame, self.frames)
        counts = []
        max_matches = 0
        for kfi, res in zip(self.frames, results):
            n = res.num_matches
            kfi.reloc_query = frame.id
            kfi.reloc_score = float(n)
            counts.append((kfi, n))
            max_matches = max(max_matches, n)
        if max_matches == 0:
            return []
        min_matches = 0.8 * max_matches

        best_acc = 0.0
        acc_frames = []
        for kfi, n in counts:
            if n < min_matches:
                continue
            best_num, best_kf, acc = float(n), kfi, float(n)
            for kf2 in kfi.get_best_covisibles(10):
                if kf2.reloc_query != frame.id:
                    continue
                acc += kf2.reloc_score
                if kf2.reloc_score > best_num:
                    best_kf, best_num = kf2, kf2.reloc_score
            acc_frames.append((best_kf, acc))
            best_acc = max(best_acc, acc)

        keep = 0.75 * best_acc
        seen = set()
        out = []
        for kfi, acc in acc_frames:
            if acc > keep and kfi not in seen:
                seen.add(kfi)
                out.append(kfi)
        return out
