"""Tracking: the per-frame front-end state machine.

Capability twin of the reference Tracking (slam_pipeline/include/Tracking.h,
src/Tracking.cc). States NO_IMAGES_YET / NOT_INITIALIZED / OK / LOST
(Tracking.h:69-75); per-frame flow (Tracking.cc:102-217):
initialization -> motion-model/reference-KF tracking -> local-map tracking ->
keyframe decision; relocalization on loss; trajectory bookkeeping; match-image
rendering; manual initialization gate (quirk #7: ToggleInitializationAllowed).

Host/device split: the state machine, keyframe bookkeeping and all
data-dependent branching run here in Python; every numeric stage is a device
call on the tracker's `device` (matcher, batched frustum test, pose LM —
kernel B2 on a card — and init RANSAC).

PyTorch counterpart of `mono_slam_framework_tpu/slam/tracking.py`, the
unfused reference-twin flow (`fusedTracking=False`). Not ported yet: the
fused steady branches (`fusedTracking=True`, refused at construction) and
relocalization (EPnP), which raises (ROADMAP §A).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from mono_slam_framework_torch.estimation import Initializer
from mono_slam_framework_torch.geometry import projection
from mono_slam_framework_torch.slam.device_io import optimize_frame_pose, run_global_ba
from mono_slam_framework_torch.slam.frame import Frame
from mono_slam_framework_torch.slam.map_model import MapPoint
from mono_slam_framework_torch.viz.match_image import render_match_image


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


class Tracking:
    def __init__(
        self,
        map_drawer,
        map_,
        kf_db,
        params,
        feature_matcher,
        frame_factory,
        keyframe_factory,
        local_mapper=None,
        loop_closer=None,
        rng_seed: int = 0,
        verbose: bool = True,
        device: torch.device | str = "cuda",
    ):
        if getattr(params, "fusedTracking", False):
            raise NotImplementedError(
                "fusedTracking=True (the fused steady path around "
                "slam/fused_tracking.steady_step): ROADMAP §A; pass "
                "fusedTracking=False for the reference-twin flow"
            )
        self.device = torch.device(device)
        self.state = TrackingState.NO_IMAGES_YET
        self.map_drawer = map_drawer
        self.map = map_
        self.kf_db = kf_db
        self.params = params
        self.matcher = feature_matcher
        self.frame_factory = frame_factory
        self.keyframe_factory = keyframe_factory
        self.local_mapper = local_mapper
        self.loop_closer = loop_closer
        self.verbose = verbose

        self.K = np.array(
            [
                [params.fx, 0, params.cx],
                [0, params.fy, params.cy],
                [0, 0, 1],
            ],
            np.float32,
        )
        self.img_width = int(params.cx * 2)
        self.img_height = int(params.cy * 2)

        self.min_frames = params.minFrames
        self.max_frames = params.maxFrames
        self.min_local_match_count = params.minLocalMatchCount
        self.min_ini_match_count = params.minIniMatchCount
        self.minimum_keyframes = params.minimumKeyFrames
        self.min_parallax = float(params.minimumParallax)
        self.octave_information = getattr(params, "octaveInformation", True)

        self.initialization_allowed = False
        self.initializer: Initializer | None = None
        self.initial_frame: Frame | None = None
        self.ini_match_result = None
        self.ini_p3d = None
        self.ini_triangulated = None

        self.current_frame: Frame | None = None
        self.last_frame: Frame | None = None
        self.velocity: np.ndarray | None = None
        self.reference_kf = None
        self.last_keyframe = None
        self.last_keyframe_id = 0
        self.last_reloc_frame_id = 0
        self.local_keyframes: list = []
        self.n_matches_inliers = 0

        # trajectory bookkeeping (Tracking.cc:201-216)
        self.relative_frame_poses: list = []
        self.references: list = []
        self.frame_times: list = []
        self.lost_flags: list = []

        self.current_match_image = np.zeros(
            (self.img_height, self.img_width * 2, 3), np.uint8
        )
        # the initializer's RANSAC draws (the JAX package's PRNG key), on
        # the host so that one seed draws alike on every device
        self._generator = torch.Generator()
        self._generator.manual_seed(rng_seed)

        # structured per-frame metrics (SURVEY.md §5 observability row)
        self.last_metrics: dict = {}

    # ------------------------------------------------------------------
    def _infos(self, res):
        """Per-row (info1, info2) InvSigma2 weights for a match result,
        honoring the octaveInformation flag (identity = fork behavior)."""
        if self.octave_information:
            return res.info1, res.info2
        ones = np.ones(res.num_matches, np.float32)
        return ones, ones

    def _log(self, *args):
        if self.verbose:
            print(*args)

    def toggle_initialization_allowed(self) -> None:
        self.initialization_allowed = True

    def set_minimum_keyframes(self, n: int) -> None:
        self.minimum_keyframes = n

    def get_current_match_image(self):
        return self.current_match_image

    # ------------------------------------------------------------------
    def grab_image_monocular(self, image, timestamp: float):
        """Per-frame entry (Tracking::GrabImageMonocular, 95-100)."""
        self.current_frame = self.frame_factory.create(image, timestamp, self.K)
        self.track()
        return self.current_frame.get_pose()

    def track(self) -> None:
        if self.state == TrackingState.NO_IMAGES_YET:
            self.state = TrackingState.NOT_INITIALIZED

        if self.state == TrackingState.NOT_INITIALIZED:
            if self.map.n_map_points() == 0:
                self.monocular_initialization()
                if self.map_drawer is not None:
                    self.map_drawer.update()
            if self.state != TrackingState.OK:
                self._update_metrics()
                return
        else:
            ok = False
            if self.state == TrackingState.OK:
                self.check_replaced_in_last_frame()
                if (
                    self.velocity is None
                    or self.current_frame.id < self.last_reloc_frame_id + 2
                ):
                    ok = self.track_reference_keyframe()
                else:
                    ok = self.track_with_motion_model()
                    if not ok:
                        ok = self.track_reference_keyframe()
            else:
                ok = self.relocalization()

            self.current_frame.reference_kf = self.reference_kf

            if ok:
                ok = self.track_local_map()
            if ok:
                self.state = TrackingState.OK
            else:
                self.state = TrackingState.LOST
                self._log("Tracking lost ...")

            if ok:
                # motion model update (Tracking.cc:155-165)
                if self.last_frame.Tcw is not None:
                    last_twc = np.eye(4, dtype=np.float32)
                    last_twc[:3, :3] = self.last_frame.get_rotation_inverse()
                    last_twc[:3, 3] = self.last_frame.get_camera_center()
                    self.velocity = self.current_frame.Tcw @ last_twc
                else:
                    self.velocity = None
                if self.need_new_keyframe():
                    self.create_new_keyframe()

            if self.state == TrackingState.LOST:
                if self.map.n_keyframes() <= self.minimum_keyframes:
                    self._log("Track lost soon after initialisation, reseting...")
                    self.reset()
                    self._update_metrics(state="RESET")
                    return

            if self.state == TrackingState.OK and self.map_drawer is not None:
                self.map_drawer.update()
                pos = self.current_frame.get_camera_center()
                direction = self.current_frame.get_rotation_inverse() @ np.array(
                    [0, 0, 1.0], np.float32
                )
                nrm = np.linalg.norm(direction)
                if nrm > 0:
                    direction = direction / nrm
                self.map_drawer.set_pos_dir(*pos, *direction)

            if self.current_frame.reference_kf is None:
                self.current_frame.reference_kf = self.reference_kf

            self.last_frame = self.frame_factory.clone(self.current_frame)

        # trajectory bookkeeping (201-216); guard the empty-list edge (B4)
        if self.current_frame.Tcw is not None:
            tcr = (
                self.current_frame.Tcw
                @ self.current_frame.reference_kf.get_pose_inverse()
            )
            self.relative_frame_poses.append(tcr)
            self.references.append(self.current_frame.reference_kf)
            self.frame_times.append(self.current_frame.timestamp)
            self.lost_flags.append(self.state == TrackingState.LOST)
        elif self.relative_frame_poses:
            self.relative_frame_poses.append(self.relative_frame_poses[-1])
            self.references.append(self.references[-1])
            self.frame_times.append(self.frame_times[-1])
            self.lost_flags.append(self.state == TrackingState.LOST)

        self._update_metrics()

    def _update_metrics(self, state: str | None = None) -> None:
        self.last_metrics = {
            "frame_id": self.current_frame.id,
            "state": state or self.state.name,
            "inliers": self.n_matches_inliers,
            "n_kf": self.map.n_keyframes(),
            "n_mp": self.map.n_map_points(),
        }

    # ------------------------------------------------------------------
    def monocular_initialization(self) -> None:
        """Two-frame bootstrap (Tracking.cc:219-275)."""
        if self.initializer is None:
            if self.current_frame is not None:
                self.initial_frame = self.frame_factory.clone(self.current_frame)
                self.last_frame = self.frame_factory.clone(self.current_frame)
                self.initializer = Initializer(
                    self.current_frame.K,
                    sigma=self.params.sigma,
                    iterations=self.params.ransac_iterations,
                    model_fallback=getattr(
                        self.params, "initializerModelFallback", False
                    ),
                    device=self.device,
                )
            return

        self.ini_match_result = self.matcher.match_frames(
            self.initial_frame, self.current_frame
        )
        self.create_current_match_image(self.ini_match_result)

        if not self.initialization_allowed:
            return

        if self.ini_match_result.num_matches < self.min_ini_match_count:
            self._log("Not enough matches to start initialization ...")
            self.initializer = None
            return

        res = self.initializer.initialize(
            self.ini_match_result.kp1_f,
            self.ini_match_result.kp2_f,
            self._generator,
            min_triangulated=self.min_ini_match_count,
            min_parallax=self.min_parallax,
        )
        if res.success:
            self.ini_p3d = res.points3d
            self.ini_triangulated = res.triangulated
            self.initial_frame.set_pose(np.eye(4, dtype=np.float32))
            Tcw = np.eye(4, dtype=np.float32)
            Tcw[:3, :3] = res.R21
            Tcw[:3, 3] = res.t21
            self.current_frame.set_pose(Tcw)
            self.create_initial_map_monocular()
        else:
            self._log("Initialization failed!")

    def create_initial_map_monocular(self) -> None:
        """Seed the map from the two init frames (Tracking.cc:277-363)."""
        self.map.clear()
        kf_ini = self.keyframe_factory.create(self.initial_frame, self.map, self.kf_db)
        kf_cur = self.keyframe_factory.create(self.current_frame, self.map, self.kf_db)
        self.map.add_keyframe(kf_ini)
        self.map.add_keyframe(kf_cur)
        # registered FIRST so map.origin_kf_id() already anchors the init
        # global BA's gauge and the spanning-tree root below (the reference
        # appends at the end, Tracking.cc:361, but reads mnId==0 instead —
        # see Map.origin_kf_id)
        self.map.keyframe_origins.append(kf_ini)

        kp1f = self.ini_match_result.kp1_f
        kp2f = self.ini_match_result.kp2_f
        inf1, inf2 = self._infos(self.ini_match_result)
        for i in range(self.ini_match_result.num_matches):
            if not self.ini_triangulated[i]:
                continue
            mp = MapPoint(self.ini_p3d[i], kf_cur, self.map)
            kp1 = tuple(self.ini_match_result.keypoints1[i])
            kp2 = tuple(self.ini_match_result.keypoints2[i])
            m1 = tuple(kp1f[i])
            m2 = tuple(kp2f[i])
            kf_ini.keypoint_map.set_map_point(kp1, mp, measurement=m1, info=inf1[i])
            kf_cur.keypoint_map.set_map_point(kp2, mp, measurement=m2, info=inf2[i])
            mp.add_observation(kf_ini, kp1, measurement=m1, info=inf1[i])
            mp.add_observation(kf_cur, kp2, measurement=m2, info=inf2[i])
            mp.update_normal_and_depth()
            self.current_frame.keypoint_map.set_map_point(
                kp2, mp, measurement=m2, info=inf2[i]
            )
            self.map.add_map_point(mp)

        kf_ini.update_connections()
        kf_cur.update_connections()
        self._log(f"New Map created with {self.map.n_map_points()} points")

        run_global_ba(self.map, n_iters=20, device=self.device, robust=True)

        median_depth = kf_ini.compute_scene_median_depth(2)
        inv_median = 1.0 / median_depth if median_depth > 0 else -1.0
        self._log(f"Scene depth {median_depth}")
        if (
            median_depth < 0
            or kf_cur.tracked_map_points(1) < self.min_ini_match_count
        ):
            self._log("Wrong initialization, reseting...")
            self.reset()
            return

        # normalize scale: baseline and points / median depth (322-344)
        Tc2w = kf_cur.get_pose()
        Tc2w[:3, 3] *= inv_median
        kf_cur.set_pose(Tc2w)
        for _, item in kf_ini.map_point_items():
            mp = item.map_point
            if mp is not None:
                mp.set_world_pos(mp.world_pos * inv_median)

        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kf_ini)
            self.local_mapper.insert_keyframe(kf_cur)

        self.current_frame.set_pose(kf_cur.get_pose())
        self.last_keyframe_id = self.current_frame.id
        self.last_keyframe = kf_cur
        self.local_keyframes = [kf_cur, kf_ini]
        self.reference_kf = kf_cur
        self.current_frame.reference_kf = kf_cur
        self.last_frame = self.frame_factory.clone(self.current_frame)
        self.state = TrackingState.OK

    # ------------------------------------------------------------------
    def check_replaced_in_last_frame(self) -> None:
        """Heal fused map-point pointers (Tracking.cc:365-378)."""
        for _, item in self.last_frame.keypoint_map.items():
            mp = item.map_point
            if mp is not None and mp.replaced_by is not None:
                item.map_point = mp.replaced_by

    def _associate_and_optimize(self, match_result) -> int | None:
        """Shared body of TrackReferenceKeyFrame / TrackWithMotionModel:
        associate matched pixels to the other frame's map points, run pose
        LM, purge outliers. Returns map-matched inlier count or None if not
        enough raw matches (Tracking.cc:389-424, 448-484)."""
        if match_result.num_matches < self.min_local_match_count:
            return None
        kp1f = match_result.kp1_f
        inf1, _ = self._infos(match_result)
        for i in range(match_result.num_matches):
            mp = match_result.get_map_point2(i)
            if mp is not None:
                self.current_frame.keypoint_map.set_map_point(
                    tuple(match_result.keypoints1[i]), mp,
                    measurement=tuple(kp1f[i]), info=inf1[i],
                )
        optimize_frame_pose(self.current_frame, self.device)

        n_matches_map = 0
        to_remove = []
        for idx, item in self.current_frame.keypoint_map.items():
            if item.outlier:
                item.map_point.last_frame_seen = self.current_frame.id
                to_remove.append(idx)
            elif item.map_point.n_obs > 0:
                n_matches_map += 1
        for idx in to_remove:
            self.current_frame.keypoint_map.set_map_point_by_index(idx, None)
        return n_matches_map

    def track_reference_keyframe(self) -> bool:
        """Tracking.cc:380-424."""
        res = self.matcher.match_frames(self.current_frame, self.reference_kf)
        self.create_current_match_image(res)
        n = self._associate_and_optimize_with_pose(res, self.last_frame.Tcw)
        return n is not None and n >= 10

    def _associate_and_optimize_with_pose(self, res, pose_init):
        if pose_init is None:
            return None
        self.current_frame.set_pose(pose_init)
        return self._associate_and_optimize(res)

    def update_last_frame(self) -> None:
        """Re-anchor the last frame on its reference KF (Tracking.cc:426-432)."""
        ref = self.last_frame.reference_kf
        tlr = self.relative_frame_poses[-1]
        self.last_frame.set_pose(tlr @ ref.get_pose())

    def track_with_motion_model(self) -> bool:
        """Tracking.cc:434-485."""
        self.update_last_frame()
        self.current_frame.set_pose(self.velocity @ self.last_frame.Tcw)
        self.current_frame.keypoint_map.clear()
        res = self.matcher.match_frames(self.current_frame, self.last_frame)
        self.create_current_match_image(res)
        n = self._associate_and_optimize(res)
        return n is not None and n >= 10

    # ------------------------------------------------------------------
    def track_local_map(self) -> bool:
        """Tracking.cc:487-518."""
        self.update_local_keyframes()
        self.search_local_points()
        optimize_frame_pose(self.current_frame, self.device)
        self.n_matches_inliers = 0
        for _, item in self.current_frame.keypoint_map.items():
            if not item.outlier:
                item.map_point.increase_found()
                if item.map_point.n_obs > 0:
                    self.n_matches_inliers += 1

        coeff = self.n_matches_inliers / max(self.min_local_match_count, 1)
        self._log(
            f"Tracking coefficient - {coeff}, if < 1.0 then tracking will be lost."
        )
        return self.n_matches_inliers >= self.min_local_match_count

    def update_local_keyframes(self) -> None:
        """Map-point voting + covisibility expansion, cap 80 (Tracking.cc:635-736)."""
        counter: dict = {}
        to_remove = []
        for idx, item in self.current_frame.keypoint_map.items():
            mp = item.map_point
            if not mp.is_bad:
                for kf in mp.observations:
                    counter[kf] = counter.get(kf, 0) + 1
            else:
                to_remove.append(idx)
        for idx in to_remove:
            self.current_frame.keypoint_map.set_map_point_by_index(idx, None)
        if not counter:
            return

        kf_max, n_max = None, 0
        self.local_keyframes = []
        for kf, n in counter.items():
            if kf.is_bad:
                continue
            if n > n_max:
                n_max, kf_max = n, kf
            self.local_keyframes.append(kf)
            kf.track_reference_for_frame = self.current_frame.id

        # expand with neighbors / children / parent (one each per KF,
        # mirroring the reference's break-after-first-insert loops, 685-730)
        for kf in list(self.local_keyframes):
            if len(self.local_keyframes) > 80:
                break
            for neigh in kf.get_best_covisibles(10):
                if not neigh.is_bad and neigh.track_reference_for_frame != self.current_frame.id:
                    self.local_keyframes.append(neigh)
                    neigh.track_reference_for_frame = self.current_frame.id
                    break
            for child in kf.children:
                if not child.is_bad and child.track_reference_for_frame != self.current_frame.id:
                    self.local_keyframes.append(child)
                    child.track_reference_for_frame = self.current_frame.id
                    break
            if kf.parent is not None and (
                kf.parent.track_reference_for_frame != self.current_frame.id
            ):
                self.local_keyframes.append(kf.parent)
                kf.parent.track_reference_for_frame = self.current_frame.id
                break

        if kf_max is not None:
            self.reference_kf = kf_max
            self.current_frame.reference_kf = kf_max

    def search_local_points(self) -> None:
        """Project local-map points, then batched-match the promising KFs
        (Tracking.cc:573-633). The per-point isInFrustum loop becomes one
        vectorized frustum call per frame, on the tracker's device."""
        to_remove = []
        for idx, item in self.current_frame.keypoint_map.items():
            mp = item.map_point
            if mp.is_bad:
                to_remove.append(idx)
            else:
                mp.increase_visible()
                mp.last_frame_seen = self.current_frame.id
        for idx in to_remove:
            self.current_frame.keypoint_map.set_map_point_by_index(idx, None)

        # collect candidate MPs per local KF (dedup via marker), batch frustum
        cand_mps, cand_kf_slot = [], []
        for slot, kf in enumerate(self.local_keyframes):
            for _, item in kf.map_point_items():
                mp = item.map_point
                if mp is None or mp.is_bad:
                    continue
                if mp.track_reference_for_frame == self.current_frame.id:
                    continue
                mp.track_reference_for_frame = self.current_frame.id
                if mp.last_frame_seen != self.current_frame.id:
                    cand_mps.append(mp)
                    cand_kf_slot.append(slot)

        n_to_match = np.zeros(len(self.local_keyframes), np.int64)
        if cand_mps:
            def dev(a):
                return torch.from_numpy(np.asarray(a, np.float32)).to(self.device)

            vis = projection.in_frustum(
                dev(self.current_frame.Tcw),
                dev(self.K),
                dev(np.stack([mp.world_pos for mp in cand_mps])),
                dev(np.stack([mp.normal for mp in cand_mps])),
                dev([mp.distance_invariance() for mp in cand_mps]),
                self.img_width,
                self.img_height,
                viewing_cos_limit=0.5,
            ).cpu().numpy()
            for mp, slot, v in zip(cand_mps, cand_kf_slot, vis):
                if v:
                    mp.increase_visible()
                    n_to_match[slot] += 1

        targets = [
            kf for slot, kf in enumerate(self.local_keyframes) if n_to_match[slot] > 0
        ]
        if not targets:
            return
        results = self.matcher.match_against_many(self.current_frame, targets)
        for res in results:
            kp1f = res.kp1_f
            inf1, _ = self._infos(res)
            for i in range(res.num_matches):
                mp1 = res.get_map_point1(i)
                mp2 = res.get_map_point2(i)
                if mp1 is None and mp2 is not None:
                    self.current_frame.keypoint_map.set_map_point(
                        tuple(res.keypoints1[i]), mp2,
                        measurement=tuple(kp1f[i]), info=inf1[i],
                    )

    # ------------------------------------------------------------------
    def need_new_keyframe(self) -> bool:
        """Tracking.cc:520-556."""
        n_kfs = self.map.n_keyframes()
        if (
            self.current_frame.id < self.last_reloc_frame_id + self.max_frames
            and n_kfs > self.max_frames
        ):
            # Reference behavior: no KF insertion for maxFrames after a
            # relocalization (Tracking.cc:525-527). With a fast camera this
            # starves the map while inliers decay (KNOWN_ISSUES.md). Opt-in
            # escape hatch: allow insertion during the cooldown when tracked
            # inliers fall below relocCooldownInlierFloor (0 = reference
            # behavior, the default).
            floor = getattr(self.params, "relocCooldownInlierFloor", 0)
            if not (floor > 0 and 0 < self.n_matches_inliers < floor):
                return False
        n_min_obs = 3 if n_kfs > 2 else 2
        n_ref_matches = self.reference_kf.tracked_map_points(n_min_obs)
        th_ref_ratio = 0.9
        c1a = self.current_frame.id >= self.last_keyframe_id + self.max_frames
        c1b = self.current_frame.id >= self.last_keyframe_id + self.min_frames
        c2 = (
            self.n_matches_inliers < n_ref_matches * th_ref_ratio
            and self.n_matches_inliers > self.min_local_match_count
        )
        if self.n_matches_inliers > 0:  # guard reference quirk B5 (div by 0)
            coeff = n_ref_matches * th_ref_ratio / self.n_matches_inliers
            self._log(
                f"New KeyFrame coeff - {coeff}, shoule be > 1 to create new KF"
            )
        return (c1a or c1b) and c2

    def create_new_keyframe(self) -> None:
        """Tracking.cc:558-571."""
        self._log("New KF created")
        kf = self.keyframe_factory.create(self.current_frame, self.map, self.kf_db)
        self.reference_kf = kf
        self.current_frame.reference_kf = kf
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kf)
        self.last_keyframe_id = self.current_frame.id
        self.last_keyframe = kf

    # ------------------------------------------------------------------
    def relocalization(self) -> bool:
        """EPnP-RANSAC relocalization over DB candidates (Tracking.cc:738-864):
        not ported yet."""
        raise NotImplementedError("relocalization: ROADMAP §A")

    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Full system reset (Tracking.cc:866-895)."""
        self._log("System Reseting")
        if self.local_mapper is not None:
            self._log("Reseting Local Mapper... done")
            self.local_mapper.reset()
        if self.loop_closer is not None:
            self._log("Reseting Loop Closing... done")
            self.loop_closer.reset()
        self._log("Reseting Database... done")
        self.kf_db.clear()
        self.map.clear()
        self.state = TrackingState.NO_IMAGES_YET
        self.initializer = None
        self.initialization_allowed = False
        self.relative_frame_poses.clear()
        self.references.clear()
        self.frame_times.clear()
        self.lost_flags.clear()
        if self.matcher is not None:
            self.matcher.drop_frame_cache()

    # ------------------------------------------------------------------
    def create_current_match_image(self, match_result) -> None:
        """Side-by-side match rendering (Tracking.cc:899-940, quirk B6: always
        rebuilt; part of the public API via GetCurrentMatchImage)."""
        self.current_match_image = render_match_image(match_result)
