"""Local mapping: keyframe processing, triangulation, fusion, culling.

Capability twin of the reference LocalMapping (include/LocalMapping.h,
src/LocalMapping.cc). `run()` is a single drain-one-keyframe step called
synchronously from System per frame (reference design choice #4, SURVEY.md §0;
src/System.cc:63-75 — no threads).

Device usage: triangulation of all matches against every neighbor KF is one
batched DLT call (replacing the per-match 4x4 SVD loop at
LocalMapping.cc:195-281); local BA is the Schur LM (optim/bundle_adjust.py).

PyTorch counterpart of `mono_slam_framework_tpu/slam/local_mapping.py`; the
device ops run on the `device` given at construction. The JAX package's
capacity ladders and prewarming are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from mono_slam_framework_torch.geometry import triangulation
from mono_slam_framework_torch.slam.device_io import run_local_ba
from mono_slam_framework_torch.slam.map_model import MapPoint


class LocalMapping:
    def __init__(self, map_, feature_matcher, params, device, verbose: bool = True):
        self.map = map_
        self.matcher = feature_matcher
        self.device = torch.device(device)
        self.min_parallax = float(params.minimumParallax)
        self.octave_information = getattr(params, "octaveInformation", True)
        self.new_keyframes: list = []
        self.recent_map_points: list = []
        self.current_kf = None
        self.loop_closer = None
        self.verbose = verbose

    def _log(self, *a):
        if self.verbose:
            print(*a)

    def set_loop_closer(self, lc) -> None:
        self.loop_closer = lc

    def insert_keyframe(self, kf) -> None:
        self.new_keyframes.append(kf)

    def check_new_keyframes(self) -> bool:
        return bool(self.new_keyframes)

    def release(self) -> None:
        self.new_keyframes.clear()
        self._log("Local Mapping RELEASE")

    def reset(self) -> None:
        self.new_keyframes.clear()
        self.recent_map_points.clear()

    # ------------------------------------------------------------------
    def run(self) -> None:
        """One drain-one-keyframe step (LocalMapping::Run, 43-70)."""
        if not self.check_new_keyframes():
            return
        self.process_new_keyframe()
        self.map_point_culling()
        self.create_new_map_points()
        self.search_in_neighbors()
        if self.map.n_keyframes() > 2:
            run_local_ba(self.current_kf, self.map, self.device)
        self._log("Local BA done")
        self.keyframe_culling()
        if self.loop_closer is not None:
            self.loop_closer.insert_keyframe(self.current_kf)

    def process_new_keyframe(self) -> None:
        """LocalMapping.cc:78-108."""
        self.current_kf = self.new_keyframes.pop(0)
        for idx, item in list(self.current_kf.map_point_items()):
            mp = item.map_point
            if mp is None or mp.is_bad:
                continue
            if not mp.is_in_keyframe(self.current_kf):
                kp = self.current_kf.keypoint_map.keypoint_from_index(idx)
                mp.add_observation(
                    self.current_kf, kp,
                    measurement=self.current_kf.keypoint_map.measurement_at(idx),
                    info=self.current_kf.keypoint_map.info_at(idx),
                )
                mp.update_normal_and_depth()
            else:
                # only init-inserted points reach here (LocalMapping.cc:94-98)
                self.recent_map_points.append(mp)
        self.current_kf.update_connections()
        self.map.add_keyframe(self.current_kf)

    def map_point_culling(self) -> None:
        """LocalMapping.cc:110-134."""
        current_id = self.current_kf.id
        kept = []
        for mp in self.recent_map_points:
            if mp.is_bad:
                continue
            if mp.found_ratio() < 0.25:
                mp.set_bad_flag()
            elif current_id - mp.first_kf_id >= 2 and mp.n_obs <= 2:
                mp.set_bad_flag()
            elif current_id - mp.first_kf_id >= 3:
                continue  # passed probation; drop from the watch list
            else:
                kept.append(mp)
        self.recent_map_points = kept

    def create_new_map_points(self) -> None:
        """Triangulate new points against <=20 covisible KFs
        (LocalMapping.cc:136-294) in TWO device calls for the whole sweep:
        one batched match against every passing neighbor, one batched
        gated-DLT over all pairs."""
        neighbors = self.current_kf.get_best_covisibles(20)
        kf1 = self.current_kf
        Rcw1 = kf1.get_rotation()
        tcw1 = kf1.get_translation()
        Tcw1 = np.hstack([Rcw1, tcw1[:, None]])
        Ow1 = kf1.get_camera_center()
        K = kf1.K
        # the reference aborts the sweep when new keyframes queue up, but
        # only from the SECOND neighbor on (`i > 0 && CheckNewKeyFrames()`,
        # LocalMapping.cc:147-149): neighbor index 0 is always processed.
        # In this sequential runtime the queue cannot grow mid-call, so a
        # non-empty queue truncates the sweep to that first neighbor.
        if self.check_new_keyframes():
            neighbors = neighbors[:1]

        # host-only baseline/median-depth gates first (LocalMapping.cc:162-174)
        pass_kfs = []
        for kf2 in neighbors:
            Ow2 = kf2.get_camera_center()
            baseline = float(np.linalg.norm(Ow2 - Ow1))
            median_depth2 = kf2.compute_scene_median_depth(2)
            if median_depth2 <= 0 or baseline / median_depth2 < 0.01:
                continue
            pass_kfs.append(kf2)

        n_new = 0
        n_candidates = 0
        if pass_kfs:
            results = self.matcher.match_against_many(kf1, pass_kfs)
            B = len(pass_kfs)
            # pairs padded to the longest match list; padded rows are masked
            # and benign K/pose values keep the math finite
            mcap = max(1, max(r.num_matches for r in results))
            uv1b = np.zeros((B, mcap, 2), np.float32)
            uv2b = np.zeros((B, mcap, 2), np.float32)
            vmaskb = np.zeros((B, mcap), bool)
            K2b = np.zeros((B, 3, 3), np.float32)
            Tcw2b = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
            for bi, (kf2, res) in enumerate(zip(pass_kfs, results)):
                n = res.num_matches
                uv1b[bi, :n] = res.kp1_f
                uv2b[bi, :n] = res.kp2_f
                vmaskb[bi, :n] = True
                K2b[bi] = kf2.K
                Tcw2b[bi, :3, :3] = kf2.get_rotation()
                Tcw2b[bi, :3, 3] = kf2.get_translation()
            Tcw1f = np.eye(4, dtype=np.float32)
            Tcw1f[:3] = Tcw1

            def dev(a):
                return torch.from_numpy(np.asarray(a, np.float32)).to(self.device)

            Xb, okb = triangulation.triangulate_gated_many(
                dev(uv1b), dev(uv2b), torch.from_numpy(vmaskb).to(self.device),
                dev(K), dev(K2b), dev(Tcw1f), dev(Tcw2b), self.min_parallax,
            )
            Xb, okb = Xb.cpu().numpy(), okb.cpu().numpy()

            # replay per pair in neighbor order (identical host semantics:
            # triangulation depends only on static poses, not map state)
            for bi, (kf2, res) in enumerate(zip(pass_kfs, results)):
                n = res.num_matches
                n_candidates += n
                if n == 0:
                    continue
                X, ok = Xb[bi][:n], okb[bi][:n]
                uv1, uv2 = uv1b[bi][:n], uv2b[bi][:n]
                if self.octave_information:
                    inf1, inf2 = res.info1, res.info2
                else:
                    inf1 = inf2 = np.ones(res.num_matches, np.float32)
                for k in np.nonzero(ok)[0]:
                    mp = MapPoint(X[k], kf1, self.map)
                    kp1 = tuple(res.keypoints1[k])
                    kp2 = tuple(res.keypoints2[k])
                    m1 = tuple(uv1[k])
                    m2 = tuple(uv2[k])
                    mp.add_observation(kf1, kp1, measurement=m1, info=inf1[k])
                    mp.add_observation(kf2, kp2, measurement=m2, info=inf2[k])
                    kf1.keypoint_map.set_map_point(
                        kp1, mp, measurement=m1, info=inf1[k]
                    )
                    kf2.keypoint_map.set_map_point(
                        kp2, mp, measurement=m2, info=inf2[k]
                    )
                    mp.update_normal_and_depth()
                    self.map.add_map_point(mp)
                    self.recent_map_points.append(mp)
                    n_new += 1

        if n_new > 0:
            self._log(f"New MPs created {n_new}")
        else:
            self._log(f"Failed to create new MPs, candidates {n_candidates}")
        self._log(f"KF num {self.map.n_keyframes()}")
        self._log(f"MP num {self.map.n_map_points()}")

    def search_in_neighbors(self) -> None:
        """Fuse duplicate points with 1st/2nd-order neighbors
        (LocalMapping.cc:296-362); matching is one batched call."""
        targets = []
        for kf in self.current_kf.get_best_covisibles(20):
            if kf.is_bad or kf.fuse_target_for_kf == self.current_kf.id:
                continue
            targets.append(kf)
            kf.fuse_target_for_kf = self.current_kf.id
            for kf2 in kf.get_best_covisibles(5):
                if (
                    kf2.is_bad
                    or kf2.fuse_target_for_kf == self.current_kf.id
                    or kf2.id == self.current_kf.id
                ):
                    continue
                targets.append(kf2)
        if targets:
            results = self.matcher.match_against_many(self.current_kf, targets)
            # normal/depth refreshes are deferred and deduplicated: the fuse
            # sweep touches the same points many times across targets, and
            # only the final state matters (nothing inside the sweep reads
            # normals) — one update per touched point at the end
            touched: dict = {}
            for kf, res in zip(targets, results):
                if self.octave_information:
                    inf1, inf2 = res.info1, res.info2
                else:
                    inf1 = inf2 = np.ones(res.num_matches, np.float32)
                for i in range(res.num_matches):
                    mp1 = res.get_map_point1(i)
                    mp2 = res.get_map_point2(i)
                    if mp1 is not None and mp2 is not None:
                        if not mp1.is_bad and not mp2.is_bad:
                            if mp2.n_obs > mp1.n_obs:
                                mp1.replace(mp2)
                            else:
                                mp2.replace(mp1)
                            touched[id(mp1)] = mp1
                            touched[id(mp2)] = mp2
                    elif mp1 is None and mp2 is not None:
                        m1 = tuple(res.kp1_f[i])
                        mp2.add_observation(
                            self.current_kf, tuple(res.keypoints1[i]),
                            measurement=m1, info=inf1[i],
                        )
                        self.current_kf.keypoint_map.set_map_point(
                            tuple(res.keypoints1[i]), mp2,
                            measurement=m1, info=inf1[i],
                        )
                        touched[id(mp2)] = mp2
                    elif mp1 is not None and mp2 is None:
                        m2 = tuple(res.kp2_f[i])
                        mp1.add_observation(
                            kf, tuple(res.keypoints2[i]),
                            measurement=m2, info=inf2[i],
                        )
                        kf.keypoint_map.set_map_point(
                            tuple(res.keypoints2[i]), mp1,
                            measurement=m2, info=inf2[i],
                        )
                        touched[id(mp1)] = mp1
            for mp in touched.values():
                if not mp.is_bad:
                    mp.update_normal_and_depth()
        self.current_kf.update_connections()

    def keyframe_culling(self) -> None:
        """Cull covisible KFs whose points are >=90% redundantly observed
        (LocalMapping.cc:369-420)."""
        n_bad = 0
        origin_id = self.map.origin_kf_id()
        for kf in self.current_kf.get_covisibles():
            if kf.id == origin_id:
                continue
            th_obs = 3
            n_redundant = 0
            n_mps = 0
            for _, item in kf.map_point_items():
                mp = item.map_point
                if mp is None or mp.is_bad:
                    continue
                n_mps += 1
                if mp.n_obs > th_obs:
                    n_other = sum(1 for okf in mp.observations if okf is not kf)
                    if n_other >= th_obs:
                        n_redundant += 1
            if n_redundant > 0.9 * n_mps:
                kf.set_bad_flag()
                n_bad += 1
        self._log(f"Bad KF {n_bad}")
