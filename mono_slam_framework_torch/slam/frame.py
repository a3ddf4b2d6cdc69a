"""Frames and the pixel -> map-point association table.

A copy of `mono_slam_framework_tpu/slam/frame.py` (host-side numpy),
including what the fused paths use: the association table's version counter
(the key of slam/fused_host.py's caches) and its bulk insert. Capability twins of the reference's FrameBase/Frame/FrameFactory
(slam_pipeline/include/FrameBase.h, Frame.h, src/FrameBase.cc, Frame.cc) and
KeyPointMap (include/KeyPointMap.h, src/KeyPointMap.cc).

Design split: the image is the caller's host array, moved to the matcher's
device when features are extracted; poses and the association table live on
the host (numpy / dict) because they feed the branchy tracking logic. Device
stages receive arrays gathered from these tables.

Reference quirk B1 preserved: KeyPointMap's "diameter" neighborhood lookup is
a no-op in the reference (src/KeyPointMap.cc:74-83 never moves off the center
cell), so the effective contract is EXACT-PIXEL lookup — implemented here as
a plain dict keyed by index = y*cols + x (src/KeyPointMap.cc:39).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class MapPointItem:
    map_point: object  # MapPoint
    outlier: bool = False
    # Subpixel measurement for the geometry stages; defaults to the integer
    # pixel key (the public association contract stays exact-integer, B1).
    measurement: tuple | None = None
    # Measurement information weight (InvSigma2 of the detection octave);
    # consumed by the optimizers (upstream ORB-SLAM2 weighting the fork
    # dropped at Optimizer.cc:141,265).
    info: float = 1.0


class KeyPointMap:
    """Sparse pixel-index -> {MapPoint, outlier} association."""

    def __init__(self, cols: int, rows: int):
        self.cols = int(cols)
        self.rows = int(rows)
        self._items: dict[int, MapPointItem] = {}
        # bumped on every structural change; consumers (the fused tracking
        # path) cache derived arrays keyed by (owner id, version)
        self.version = 0

    def clone(self) -> "KeyPointMap":
        m = KeyPointMap(self.cols, self.rows)
        m._items = {
            k: MapPointItem(v.map_point, v.outlier, v.measurement, v.info)
            for k, v in self._items.items()
        }
        return m

    def clear(self) -> None:
        self._items.clear()
        self.version += 1

    def index_of(self, keypoint) -> int:
        x, y = int(keypoint[0]), int(keypoint[1])
        return y * self.cols + x

    def keypoint_from_index(self, index: int):
        y = index // self.cols
        return (index - y * self.cols, y)

    def _in_bounds(self, keypoint) -> bool:
        x, y = int(keypoint[0]), int(keypoint[1])
        return 0 <= x < self.cols and 0 <= y < self.rows

    def set_map_point(self, keypoint, map_point, measurement=None, info=1.0) -> None:
        if not self._in_bounds(keypoint):
            return
        idx = self.index_of(keypoint)
        if map_point is None:
            self._items.pop(idx, None)
        else:
            self._items[idx] = MapPointItem(
                map_point, measurement=measurement, info=float(info)
            )
        self.version += 1

    def set_map_point_by_index(self, index: int, map_point) -> None:
        self.set_map_point(self.keypoint_from_index(index), map_point)

    def bulk_set_map_points(self, indices, map_points, measurements, infos) -> None:
        """Vectorized SetMapPoint over precomputed pixel indices (the fused
        replay path: coordinates already validated on the device, pixel
        uniqueness already resolved). One version bump for the batch."""
        items = self._items
        for idx, mp, meas, info in zip(indices, map_points, measurements, infos):
            items[idx] = MapPointItem(mp, measurement=meas, info=info)
        self.version += 1

    def measurement_at(self, index: int):
        """Float measurement for an association (defaults to the pixel key)."""
        item = self._items.get(index)
        if item is not None and item.measurement is not None:
            return item.measurement
        return self.keypoint_from_index(index)

    def info_at(self, index: int) -> float:
        """Measurement information weight for an association (default 1.0)."""
        item = self._items.get(index)
        return item.info if item is not None else 1.0

    def get_map_point(self, keypoint):
        if not self._in_bounds(keypoint):
            return None
        item = self._items.get(self.index_of(keypoint))
        return item.map_point if item else None

    def set_outlier(self, index: int, outlier: bool) -> None:
        item = self._items.get(index)
        if item is not None:
            item.outlier = outlier

    def is_outlier(self, index: int) -> bool:
        item = self._items.get(index)
        return bool(item.outlier) if item else False

    def items(self):
        """Iterate (index, MapPointItem) — the reference's Begin()/End()."""
        return self._items.items()

    def indices(self):
        return list(self._items.keys())

    @property
    def size(self) -> int:
        return len(self._items)


class FrameBase:
    """Image + intrinsics + pose caches (FrameBase.cc:5-76)."""

    _next_matcher_key = 0

    def __init__(self, image, K: np.ndarray):
        self.image = image  # numpy [H, W] grayscale
        # Feature-cache identity: unique per distinct image. Clones and the
        # KeyFrames created from a frame share the source frame's key (same
        # pixels -> same features), so a frame's features are extracted once.
        self.matcher_key = FrameBase._next_matcher_key
        FrameBase._next_matcher_key += 1
        h, w = image.shape
        self.keypoint_map = KeyPointMap(w, h)
        self.K = np.asarray(K, np.float32)
        self.min_x, self.max_x = 0.0, float(w)
        self.min_y, self.max_y = 0.0, float(h)
        self.Tcw: Optional[np.ndarray] = None
        self.Rcw = self.Rwc = self.tcw = self.Ow = self.Twc = None

    @property
    def fx(self):
        return float(self.K[0, 0])

    @property
    def fy(self):
        return float(self.K[1, 1])

    @property
    def cx(self):
        return float(self.K[0, 2])

    @property
    def cy(self):
        return float(self.K[1, 2])

    def set_pose(self, Tcw: np.ndarray) -> None:
        self.Tcw = np.asarray(Tcw, np.float32).copy()
        self.Rcw = self.Tcw[:3, :3]
        self.Rwc = self.Rcw.T.copy()
        self.tcw = self.Tcw[:3, 3]
        self.Ow = -self.Rwc @ self.tcw
        self.Twc = np.eye(4, dtype=np.float32)
        self.Twc[:3, :3] = self.Rwc
        self.Twc[:3, 3] = self.Ow

    def get_pose(self):
        return None if self.Tcw is None else self.Tcw.copy()

    def get_pose_inverse(self):
        return None if self.Twc is None else self.Twc.copy()

    def get_camera_center(self):
        return None if self.Ow is None else self.Ow.copy()

    def get_rotation(self):
        return None if self.Rcw is None else self.Rcw.copy()

    def get_rotation_inverse(self):
        return None if self.Rwc is None else self.Rwc.copy()

    def get_translation(self):
        return None if self.tcw is None else self.tcw.copy()


class Frame(FrameBase):
    """Per-image tracking frame (Frame.cc:29-92)."""

    next_id = 0

    def __init__(self, image, timestamp: float, K: np.ndarray, _id=None):
        super().__init__(image, K)
        self.timestamp = float(timestamp)
        if _id is None:
            self.id = Frame.next_id
            Frame.next_id += 1
        else:
            self.id = _id
        self.reference_kf = None

    def clone(self) -> "Frame":
        f = Frame(self.image, self.timestamp, self.K, _id=self.id)
        f.matcher_key = self.matcher_key  # same image -> same features
        f.keypoint_map = self.keypoint_map.clone()
        f.reference_kf = self.reference_kf
        if self.Tcw is not None:
            f.set_pose(self.Tcw)
        return f


class FrameFactory:
    """Client-extensible frame construction (include/Frame.h:65-71)."""

    def create(self, image, timestamp: float, K: np.ndarray) -> Frame:
        return Frame(image, timestamp, K)

    def clone(self, frame: Frame) -> Frame:
        return frame.clone()


def reset_frame_ids() -> None:
    Frame.next_id = 0
