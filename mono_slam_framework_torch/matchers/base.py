"""The central matcher abstraction.

Mirrors the reference's FeatureMatcher / MatchFramesResult contract
(slam_pipeline/include/FeatureMatcher.h:15-47): a matcher consumes two whole
grayscale frames and returns paired integer pixel coordinates. The whole
pipeline is written against this interface — the framework exists to compare
matchers (README.md:1-2 of the reference).

Device code keeps fixed-capacity arrays with a validity mask, and matchers
may cache per-frame features keyed by frame id — a pure optimization: the
reference re-extracts features on every call (src/featurematcher.cpp:15-17)
but the MatchFrames output is identical.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from typing import Any as FrameBase  # the host Frame types come later


@dataclasses.dataclass
class MatchFramesResult:
    """Paired integer pixel coordinates (FeatureMatcher.h:15-39).

    keypoints1/keypoints2 are dense int32 [N, 2] (x, y) arrays of equal
    length, already compacted to valid matches (host-side numpy — this is the
    host/device boundary; device code keeps the padded masked form).
    """

    frame1: "FrameBase | None" = None
    frame2: "FrameBase | None" = None
    keypoints1: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.int32)
    )
    keypoints2: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.int32)
    )
    # Optional subpixel coordinates (same rows as keypoints1/2). The public
    # contract stays integer (FeatureMatcher.h:15-39); these ride along as
    # higher-precision measurements for the geometry stages when the matcher
    # provides them (see KNOWN_ISSUES.md).
    keypoints1_f: np.ndarray | None = None
    keypoints2_f: np.ndarray | None = None
    # Optional pyramid octaves per match row. Upstream ORB-SLAM2 weights every
    # optimization edge by InvSigma2 = 1/1.2^(2*octave) (the fork dropped this
    # — identity information at Optimizer.cc:141,265); matchers that know the
    # detection scale report it here so the rebuild can restore the weighting.
    octaves1: np.ndarray | None = None
    octaves2: np.ndarray | None = None

    @property
    def num_matches(self) -> int:
        return int(self.keypoints1.shape[0])

    def _info(self, octaves) -> np.ndarray:
        if octaves is None:
            return np.ones(self.num_matches, np.float32)
        return (1.2 ** (-2.0 * octaves.astype(np.float32))).astype(np.float32)

    @property
    def info1(self) -> np.ndarray:
        """Per-row measurement information weight (InvSigma2) in frame1."""
        return self._info(self.octaves1)

    @property
    def info2(self) -> np.ndarray:
        """Per-row measurement information weight (InvSigma2) in frame2."""
        return self._info(self.octaves2)

    @property
    def kp1_f(self) -> np.ndarray:
        if self.keypoints1_f is None:
            return self.keypoints1.astype(np.float32)
        return self.keypoints1_f

    @property
    def kp2_f(self) -> np.ndarray:
        if self.keypoints2_f is None:
            return self.keypoints2.astype(np.float32)
        return self.keypoints2_f

    # Reference helpers GetMapPoint1/2 (FeatureMatcher.h:23-29): resolve a
    # match's pixel to the frame's associated map point (exact-pixel lookup,
    # quirk B1 preserved in KeyPointMap).
    def get_map_point1(self, idx: int):
        return self.frame1.keypoint_map.get_map_point(tuple(self.keypoints1[idx]))

    def get_map_point2(self, idx: int):
        return self.frame2.keypoint_map.get_map_point(tuple(self.keypoints2[idx]))


class FeatureMatcher(abc.ABC):
    """Abstract matcher (FeatureMatcher.h:41-47)."""

    @abc.abstractmethod
    def match_frames(self, frame1, frame2) -> MatchFramesResult:
        """Search keypoint matches between two frame images."""

    # Reference plugins expose SetThreshold (featurematcher.cpp:47).
    def set_threshold(self, value: float) -> None:
        raise NotImplementedError

    # Optional batched interface: match one query frame against a stack of
    # stored keyframes in a single device call (used by the keyframe database
    # to turn the reference's O(N) serial scan, KeyFrameDatabase.cc:31/63,
    # into one batched program). Default: loop.
    def match_against_many(self, frame, others):
        return [self.match_frames(frame, o) for o in others]

    def drop_frame_cache(self, frame_id=None) -> None:
        """Forget cached per-frame features (all frames if id is None)."""
