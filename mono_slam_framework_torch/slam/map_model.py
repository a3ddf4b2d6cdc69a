"""Map, KeyFrame (covisibility graph + spanning tree) and MapPoint.

Capability twins of the reference's map data model:
  * Map (include/Map.h, src/Map.cc): global KF/MP sets, big-change counter;
  * KeyFrame (include/KeyFrame.h, src/KeyFrame.cc): weighted covisibility
    graph with threshold 15 (KeyFrame.cc:223), ordered covisibles, spanning
    tree with parent reassignment on culling (KeyFrame.cc:287-372), scene
    median depth (390-414, lower median — quirk B3 documented);
  * MapPoint (include/MapPoint.h, src/MapPoint.cc): observations map
    KF -> pixel, normal/distance refresh, found/visible ratios, Replace
    fusion, bad-flag cascade.

Host-side Python: this is the branchy bookkeeping layer. Device math reads
snapshots of these tables as arrays (see slam/device_io.py).

A copy of `mono_slam_framework_tpu/slam/map_model.py`. As there, `Map()`
keeps its observations in the native C++ observation graph
(native/slamgraph.cc) when that library loads, and `update_connections`
then counts distinct (map point, keyframe) pairs; `Map(use_native_graph=
False)`, or a machine without g++, runs the pure-Python scan. The geometry
epoch counter keys slam/fused_host.py's cached device tables.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from mono_slam_framework_torch.slam.frame import Frame, FrameBase

COVIS_THRESHOLD = 15  # KeyFrame.cc:223


class _OrderedSet:
    """Insertion-ordered object set (dict-backed).

    A plain `set` of objects iterates in address-hash order, which varies
    run to run — the KF/MP sets and spanning-tree children feed walk orders
    into tracking decisions (local windows, culling sweeps), making whole
    pipeline runs non-reproducible. Dict-backed insertion order restores
    determinism at identical cost.
    """

    __slots__ = ("_d",)

    def __init__(self):
        self._d: dict = {}

    def add(self, x) -> None:
        self._d[x] = None

    def discard(self, x) -> None:
        self._d.pop(x, None)

    def clear(self) -> None:
        self._d.clear()

    def __iter__(self):
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, x) -> bool:
        return x in self._d

    def __bool__(self) -> bool:
        return bool(self._d)


def _try_native_graph():
    from mono_slam_framework_torch import native

    return native.ObservationGraph() if native.available() else None


class Map:
    def __init__(self, use_native_graph: bool = True):
        self.keyframes: "_OrderedSet" = _OrderedSet()
        self.map_points: "_OrderedSet" = _OrderedSet()
        self.max_kf_id = 0
        self.big_change_idx = 0
        # bumped on every map-point position/normal change; device-side
        # caches of geometry tables (fused tracking ctx) key on this
        self.geometry_epoch = 0
        self.keyframe_origins: list = []
        # native C++ observation/covisibility core (ctypes); None -> Python
        self.obs_graph = _try_native_graph() if use_native_graph else None
        self.kf_registry: dict[int, "KeyFrame"] = {}

    def add_keyframe(self, kf) -> None:
        self.keyframes.add(kf)
        self.max_kf_id = max(self.max_kf_id, kf.id)

    def add_map_point(self, mp) -> None:
        self.map_points.add(mp)

    def erase_map_point(self, mp) -> None:
        self.map_points.discard(mp)

    def erase_keyframe(self, kf) -> None:
        self.keyframes.discard(kf)

    def inform_new_big_change(self) -> None:
        self.big_change_idx += 1

    def get_last_big_change_idx(self) -> int:
        return self.big_change_idx

    def origin_kf_id(self) -> int:
        """Id of the map's FIRST keyframe — the BA gauge anchor, the
        cull-protected spanning-tree root, and the KF local mapping / loop
        closing skip. The reference tests `mnId == 0` for all of these
        (KeyFrame ids restart at 0 on every Reset and a process runs ONE
        System); with several Systems sharing the process-wide id counter
        (parallel.server.SlamServer) only per-map origin identity is
        correct — a second map's first keyframe has a nonzero global id,
        and `mnId == 0` would leave its initial global BA with NO fixed
        camera (free gauge: the init map drifts to an arbitrary frame)."""
        if self.keyframe_origins:
            return self.keyframe_origins[0].id
        ids = [kf.id for kf in self.keyframes if not kf.is_bad]
        return min(ids) if ids else 0

    def all_keyframes(self) -> list:
        return list(self.keyframes)

    def all_map_points(self) -> list:
        return list(self.map_points)

    def n_map_points(self) -> int:
        return len(self.map_points)

    def n_keyframes(self) -> int:
        return len(self.keyframes)

    def clear(self) -> None:
        self.keyframes.clear()
        self.map_points.clear()
        self.max_kf_id = 0
        self.keyframe_origins.clear()
        self.kf_registry.clear()
        if self.obs_graph is not None:
            self.obs_graph.clear()


class MapPoint:
    next_id = 0

    def __init__(self, pos: np.ndarray, ref_kf, map_: Map):
        self.world_pos = np.asarray(pos, np.float32).reshape(3).copy()
        self.ref_kf = ref_kf
        self.map = map_
        self.first_kf_id = ref_kf.id if ref_kf is not None else -1
        self.observations: dict = {}  # KeyFrame -> (x, y) integer pixel
        self.obs_measurements: dict = {}  # KeyFrame -> subpixel (x, y), optional
        self.obs_info: dict = {}  # KeyFrame -> InvSigma2 weight, optional
        self.n_obs = 0
        self.normal = np.zeros(3, np.float32)
        self.distance = 0.0
        self.n_visible = 1
        self.n_found = 1
        self.is_bad = False
        self.replaced_by: Optional["MapPoint"] = None
        self.last_frame_seen = 0
        self.track_reference_for_frame = -1
        self.ba_local_for_kf = -1
        self.fuse_candidate_for_kf = -1
        self.ba_global_for_kf = -1
        self.pos_gba: Optional[np.ndarray] = None
        self.id = MapPoint.next_id
        MapPoint.next_id += 1

    def set_world_pos(self, pos) -> None:
        self.world_pos = np.asarray(pos, np.float32).reshape(3).copy()
        if self.map is not None:
            self.map.geometry_epoch += 1

    def get_world_pos(self) -> np.ndarray:
        return self.world_pos.copy()

    def add_observation(self, kf, keypoint, measurement=None, info=1.0) -> None:
        if kf in self.observations:
            return
        self.observations[kf] = (int(keypoint[0]), int(keypoint[1]))
        if measurement is not None:
            self.obs_measurements[kf] = (float(measurement[0]), float(measurement[1]))
        if info != 1.0:
            self.obs_info[kf] = float(info)
        self.n_obs += 1
        if self.map is not None and self.map.obs_graph is not None:
            self.map.obs_graph.add(self.id, kf.id)

    def erase_observation(self, kf) -> None:
        if kf not in self.observations:
            return
        del self.observations[kf]
        self.obs_measurements.pop(kf, None)
        self.obs_info.pop(kf, None)
        self.n_obs -= 1
        if self.map is not None and self.map.obs_graph is not None:
            self.map.obs_graph.erase(self.id, kf.id)
        if self.ref_kf is kf and self.observations:
            self.ref_kf = next(iter(self.observations))
        # <=2 observations -> discard (MapPoint.cc:114)
        if self.n_obs <= 2:
            self.set_bad_flag()

    def set_bad_flag(self) -> None:
        self.is_bad = True
        obs = dict(self.observations)
        self.observations.clear()
        for kf, kp in obs.items():
            kf.erase_map_point_match_at(kp)
        if self.map.obs_graph is not None:
            self.map.obs_graph.erase_map_point(self.id)
        self.map.erase_map_point(self)

    def replace(self, other: "MapPoint") -> None:
        """Fuse this point into `other` (MapPoint::Replace, 141-167)."""
        if other.id == self.id:
            return
        obs = dict(self.observations)
        meas = dict(self.obs_measurements)
        infos = dict(self.obs_info)
        self.observations.clear()
        self.obs_measurements.clear()
        self.obs_info.clear()
        self.is_bad = True
        self.replaced_by = other
        if self.map.obs_graph is not None:
            self.map.obs_graph.erase_map_point(self.id)
        for kf, kp in obs.items():
            if kf not in other.observations:
                kf.keypoint_map.set_map_point(
                    kp, other, measurement=meas.get(kf), info=infos.get(kf, 1.0)
                )
                other.add_observation(
                    kf, kp, measurement=meas.get(kf), info=infos.get(kf, 1.0)
                )
            else:
                kf.erase_map_point_match_at(kp)
        other.n_found += self.n_found
        other.n_visible += self.n_visible
        self.map.erase_map_point(self)

    def increase_visible(self, n: int = 1) -> None:
        self.n_visible += n

    def increase_found(self, n: int = 1) -> None:
        self.n_found += n

    def found_ratio(self) -> float:
        return self.n_found / self.n_visible

    def is_in_keyframe(self, kf) -> bool:
        return kf in self.observations

    def keypoint_in_keyframe(self, kf):
        return self.observations.get(kf)

    def measurement_in_keyframe(self, kf):
        """Subpixel measurement for this observation (falls back to the
        integer pixel)."""
        m = self.obs_measurements.get(kf)
        return m if m is not None else self.observations.get(kf)

    def info_in_keyframe(self, kf) -> float:
        """Information weight (InvSigma2) for this observation (default 1)."""
        return self.obs_info.get(kf, 1.0)

    def update_normal_and_depth(self) -> None:
        if self.is_bad or not self.observations:
            return
        normal = np.zeros(3, np.float64)
        for kf in self.observations:
            v = self.world_pos - kf.get_camera_center()
            n = np.linalg.norm(v)
            if n > 0:
                normal += v / n
        self.normal = (normal / len(self.observations)).astype(np.float32)
        pc = self.world_pos - self.ref_kf.get_camera_center()
        self.distance = float(np.linalg.norm(pc))
        if self.map is not None:
            self.map.geometry_epoch += 1

    def distance_invariance(self) -> float:
        return 1.2 * self.distance  # MapPoint.cc:222


class KeyFrame(FrameBase):
    next_id = 0

    def __init__(self, frame: Frame, map_: Map, kf_db):
        super().__init__(frame.image, frame.K)
        self.matcher_key = frame.matcher_key  # same image -> same features
        self.frame_id = frame.id
        self.timestamp = frame.timestamp
        self.keypoint_map = frame.keypoint_map.clone()
        if frame.Tcw is not None:
            self.set_pose(frame.Tcw)
        self.map = map_
        self.kf_db = kf_db
        self.connections: dict = {}  # KeyFrame -> weight
        self.ordered_covisibles: list = []
        self.ordered_weights: list = []
        self.parent: Optional["KeyFrame"] = None
        self.children: "_OrderedSet" = _OrderedSet()
        self.first_connection = True
        self.not_erase = False
        self.to_be_erased = False
        self.is_bad = False
        self.Tcp = None
        # per-pass scratch markers (reference member variables)
        self.track_reference_for_frame = -1
        self.fuse_target_for_kf = -1
        self.ba_local_for_kf = -1
        self.ba_fixed_for_kf = -1
        self.ba_global_for_kf = -1
        self.loop_query = -1
        self.reloc_query = -1
        self.reloc_score = 0.0
        self.Tcw_gba = None
        self.Tcw_bef_gba = None
        self.id = KeyFrame.next_id
        KeyFrame.next_id += 1
        if map_ is not None:
            map_.kf_registry[self.id] = self

    # -- map point associations -------------------------------------------
    def add_map_point(self, mp: MapPoint, keypoint) -> None:
        self.keypoint_map.set_map_point(keypoint, mp)

    def erase_map_point_match_at(self, keypoint) -> None:
        self.keypoint_map.set_map_point(keypoint, None)

    def erase_map_point_match(self, mp: MapPoint) -> None:
        kp = mp.keypoint_in_keyframe(self)
        if kp is not None:
            self.keypoint_map.set_map_point(kp, None)

    def get_map_point(self, keypoint):
        return self.keypoint_map.get_map_point(keypoint)

    def map_point_items(self):
        return self.keypoint_map.items()

    def tracked_map_points(self, min_obs: int) -> int:
        n = 0
        for _, item in self.keypoint_map.items():
            mp = item.map_point
            if mp is not None and not mp.is_bad:
                if min_obs > 0:
                    if mp.n_obs >= min_obs:
                        n += 1
                else:
                    n += 1
        return n

    # -- covisibility graph -----------------------------------------------
    def add_connection(self, kf, weight: int) -> None:
        if self.connections.get(kf) == weight:
            return
        self.connections[kf] = weight
        self._update_best_covisibles()

    def erase_connection(self, kf) -> None:
        if kf in self.connections:
            del self.connections[kf]
            self._update_best_covisibles()

    def _update_best_covisibles(self) -> None:
        pairs = sorted(
            self.connections.items(), key=lambda it: (-it[1], it[0].id)
        )
        self.ordered_covisibles = [kf for kf, _ in pairs]
        self.ordered_weights = [w for _, w in pairs]

    def get_connected_keyframes(self) -> set:
        return set(self.connections.keys())

    def get_covisibles(self) -> list:
        return list(self.ordered_covisibles)

    def get_best_covisibles(self, n: int) -> list:
        return self.ordered_covisibles[:n]

    def get_covisibles_by_weight(self, w: int) -> list:
        """Covisible keyframes sharing more than `w` points, best first."""
        return [
            kf
            for kf, wt in zip(self.ordered_covisibles, self.ordered_weights)
            if wt > w
        ]

    def get_weight(self, kf) -> int:
        return self.connections.get(kf, 0)

    def update_connections(self) -> None:
        """Rebuild covisibility from shared observations (KeyFrame.cc:191-262).

        Uses the native C++ observation graph when available (Map.obs_graph);
        falls back to the Python dict scan. Minor divergence from the
        reference: the native path counts distinct (map point, keyframe)
        pairs, while the reference's KeyPointMap iteration would double-count
        a map point that fused into two pixels of the same keyframe.
        """
        counter: dict = {}
        g = self.map.obs_graph if self.map is not None else None
        if g is not None:
            for kid, w in g.covis_counts(self.id).items():
                kf = self.map.kf_registry.get(kid)
                if kf is not None:
                    counter[kf] = w
        else:
            for _, item in self.keypoint_map.items():
                mp = item.map_point
                if mp is None or mp.is_bad:
                    continue
                for kf in mp.observations:
                    if kf.id == self.id:
                        continue
                    counter[kf] = counter.get(kf, 0) + 1
        if not counter:
            return
        kf_max, n_max = None, 0
        pairs = []
        for kf, n in counter.items():
            if n > n_max:
                n_max, kf_max = n, kf
            if n >= COVIS_THRESHOLD:
                pairs.append((n, kf))
                kf.add_connection(self, n)
        if not pairs:
            pairs.append((n_max, kf_max))
            kf_max.add_connection(self, n_max)
        self.connections = counter
        self._update_best_covisibles()
        if self.first_connection and self.id != self.map.origin_kf_id():
            self.parent = self.ordered_covisibles[0]
            self.parent.add_child(self)
            self.first_connection = False

    # -- spanning tree ------------------------------------------------------
    def add_child(self, kf) -> None:
        self.children.add(kf)

    def erase_child(self, kf) -> None:
        self.children.discard(kf)

    def change_parent(self, kf) -> None:
        self.parent = kf
        kf.add_child(self)

    def set_not_erase(self) -> None:
        self.not_erase = True

    def set_erase(self) -> None:
        self.not_erase = False
        if self.to_be_erased:
            self.set_bad_flag()

    def set_bad_flag(self) -> None:
        """Cull this KF, reassigning children over covisibility weights
        (KeyFrame::SetBadFlag, 287-372)."""
        if self.id == self.map.origin_kf_id():
            return
        if self.not_erase:
            self.to_be_erased = True
            return
        for kf in list(self.connections.keys()):
            kf.erase_connection(self)
        for _, item in list(self.keypoint_map.items()):
            if item.map_point is not None:
                item.map_point.erase_observation(self)
        self.connections.clear()
        self.ordered_covisibles = []
        self.ordered_weights = []

        parent_candidates = {self.parent}
        while self.children:
            best_w, best_child, best_parent = -1, None, None
            for child in self.children:
                if child.is_bad:
                    continue
                for cand in child.get_covisibles():
                    if any(cand.id == pc.id for pc in parent_candidates if pc):
                        w = child.get_weight(cand)
                        if w > best_w:
                            best_w, best_child, best_parent = w, child, cand
            if best_child is None:
                break
            best_child.change_parent(best_parent)
            parent_candidates.add(best_child)
            self.children.discard(best_child)
        for child in list(self.children):
            child.change_parent(self.parent)
        if self.parent is not None:
            self.parent.erase_child(self)
            self.Tcp = self.Tcw @ self.parent.get_pose_inverse()
        self.is_bad = True
        self.map.erase_keyframe(self)
        if self.kf_db is not None:
            self.kf_db.erase(self)

    def compute_scene_median_depth(self, q: int = 2) -> float:
        """Lower median of map-point depths (KeyFrame.cc:390-414, quirk B3:
        the index is (n-1)//q, i.e. lower median)."""
        depths = []
        Rcw2 = self.Tcw[2, :3]
        zcw = float(self.Tcw[2, 3])
        for _, item in self.keypoint_map.items():
            mp = item.map_point
            if mp is None:
                continue
            depths.append(float(Rcw2 @ mp.world_pos + zcw))
        if not depths:
            return -1.0
        depths.sort()
        return depths[(len(depths) - 1) // q]


class KeyFrameFactory:
    """Client-extensible keyframe construction (include/KeyFrame.h:149-154)."""

    def create(self, frame: Frame, map_: Map, kf_db) -> KeyFrame:
        return KeyFrame(frame, map_, kf_db)


def reset_map_ids() -> None:
    KeyFrame.next_id = 0
    MapPoint.next_id = 0
