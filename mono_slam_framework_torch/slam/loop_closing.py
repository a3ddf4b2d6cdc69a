"""Loop closing: match-database detection, then the loop correction.

PyTorch counterpart of `mono_slam_framework_tpu/slam/loop_closing.py`, the
capability twin of the reference LoopClosing (include/LoopClosing.h,
src/LoopClosing.cc). `run` drains one keyframe, applies the cooldown and
asks the keyframe database for a candidate (one batched matcher call). A
detected loop is corrected as the JAX package corrects it:

  * fuse (`loopFuseDuplicates`, default on): the revisit keyframe's
    duplicate map points are matched against the loop keyframe and its best
    covisibles and fused into the old points (upstream ORB-SLAM2's
    SearchAndFuse, which the reference fork dropped);
  * pre-alignment (`loopPrealignSim3`, default on, before the fuse): a
    robust Sim(3) fit over the duplicate pairs (geometry/sim3.py, numpy)
    gives the loop edge of an essential graph solved on the device
    (optim/pose_graph.py); map points follow their reference keyframe;
  * a loop global BA on the device (slam/device_io.run_global_ba, staged in
    Tcw_gba / pos_gba), then its results propagated down the spanning tree
    (LoopClosing.cc:122-199).

The JAX package's debugging dumps (a `.npz` of a non-finite pose graph and
the LOOP_GRAPH_DUMP environment hook) are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from mono_slam_framework_torch.geometry import sim3 as s3
from mono_slam_framework_torch.optim.pose_graph import optimize_pose_graph_np
from mono_slam_framework_torch.slam.device_io import run_global_ba


class LoopClosing:
    def __init__(self, map_, kf_db, feature_matcher, params, device="cuda",
                 verbose: bool = True):
        self.map = map_
        self.kf_db = kf_db
        self.matcher = feature_matcher
        self.device = torch.device(device)
        self.loop_detection_max_frames = params.loopDetectionMaxFrames
        self.min_num_mp_matches = params.minNumMPMatches
        self.fuse_duplicates = getattr(params, "loopFuseDuplicates", False)
        self.prealign = getattr(params, "loopPrealignSim3", True)
        self.queue: list = []
        self.last_loop_kf_id = 0
        self.last_fuse_count = 0  # duplicates merged by the last loop fuse
        # the last pre-alignment's pairs, fit and graph size, for reports
        self.last_prealign: dict | None = None
        self.full_ba_idx = False
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
        """LoopClosing.cc:101-115, plus (fuse path) the Sim(3) chain
        pre-alignment upstream ORB-SLAM2 performs before fusing and
        optimizing: without it the polishing global BA starts a full loop
        gap outside its convergence basin and is a measured no-op (QUIRKS.md
        "loop fuse default")."""
        self._log("Loop detected!")
        self.full_ba_idx = True
        if self.fuse_duplicates:
            self.fuse_loop_duplicates()
        self.current_kf.update_connections()
        self.run_global_bundle_adjustment(self.current_kf.id)
        if self.local_mapper is not None:
            self.local_mapper.release()
        self.last_loop_kf_id = self.current_kf.id

    def _prealign_loop(self, pairs) -> bool:
        """Distribute the measured loop correction around the whole chain
        with an essential-graph (pose-graph) optimization — upstream
        ORB-SLAM2's OptimizeEssentialGraph.

        `pairs` are (mp_new, mp_old) duplicate map points: the same physical
        point as mapped by the revisit (drifted) tail and by the original
        (anchored) pass. A robust Sim(3) fit over the pairs measures the
        loop correction G; the corrected revisit pose becomes the loop edge
        of an SE(3) pose graph whose other edges (spanning tree + strong
        covisibility, weight > 100 like upstream) carry the relative poses
        the tracker measured. The graph is solved on the System's device;
        map points then follow their reference keyframe's pose delta (the
        reference's GBA-propagation rule).
        """
        # one vote per distinct (new, old) POINT: a new point matched in
        # several target keyframes, or several new points fused into one old
        # point, must not multiply-weight (and can degenerate) the fit
        seen_new, seen_old, uniq = set(), set(), []
        for mp_new, mp_old in pairs:
            kn, ko = id(mp_new), id(mp_old)
            if kn in seen_new or ko in seen_old:
                continue
            seen_new.add(kn)
            seen_old.add(ko)
            uniq.append((mp_new, mp_old))
        if len(uniq) < 8:
            return False
        new_pts = np.stack([p[0].world_pos for p in uniq])
        old_pts = np.stack([p[1].world_pos for p in uniq])
        fit = s3.fit_sim3_robust(new_pts, old_pts)
        if fit is None:
            self._log("Loop prealign: no correction improves the pairs; skipped")
            return False
        s, R, t = fit
        self.last_prealign = {"pairs": len(pairs), "unique": len(uniq), "scale": float(s),
                              "rotation": s3.rotation_angle(R),
                              "translation": float(np.linalg.norm(t))}
        self._log(
            f"Loop prealign: |pairs|={len(pairs)} uniq={len(uniq)} "
            f"scale={s:.4f} rot={s3.rotation_angle(R):.4f} "
            f"|t|={float(np.linalg.norm(t)):.4f}"
        )

        # --- essential graph ------------------------------------------------
        kfs = sorted(
            (kf for kf in self.map.all_keyframes() if not kf.is_bad),
            key=lambda k: k.id,
        )
        if len(kfs) < 3 or self.matched_kf.is_bad:
            return False
        index = {kf: i for i, kf in enumerate(kfs)}
        T_old = [kf.get_pose().astype(np.float32).copy() for kf in kfs]
        e_i, e_j, T_meas, e_w = [], [], [], []
        seen_edges = set()

        def add_edge(a, b, T_ab, w):
            key = (min(a, b), max(a, b))
            if a == b or key in seen_edges:
                return
            seen_edges.add(key)
            e_i.append(a)
            e_j.append(b)
            T_meas.append(T_ab)
            e_w.append(w)

        for kf in kfs:
            i = index[kf]
            if kf.parent is not None and kf.parent in index:
                j = index[kf.parent]
                add_edge(i, j, T_old[i] @ np.linalg.inv(T_old[j]), 1.0)
            # strong covisibility edges (KeyFrame.cc threshold heritage:
            # upstream's essential graph keeps weight > 100)
            for kf2 in kf.get_covisibles_by_weight(100):
                if kf2 in index:
                    j = index[kf2]
                    add_edge(i, j, T_old[i] @ np.linalg.inv(T_old[j]), 1.0)
        # the loop edge: corrected revisit pose vs the matched keyframe
        ic = index.get(self.current_kf)
        im = index.get(self.matched_kf)
        if ic is None or im is None:
            return False
        Tc_corr = s3.corrected_pose(T_old[ic], s, R, t)
        add_edge(ic, im, Tc_corr @ np.linalg.inv(T_old[im]), 10.0)

        fixed = np.zeros(len(kfs), bool)
        fixed[im] = True  # gauge: the matched (anchored) side stays put
        fixed[index[kfs[0]]] = True
        T_new = optimize_pose_graph_np(
            np.stack(T_old), fixed, e_i, e_j, np.stack(T_meas), e_w, device=self.device
        )
        if T_new is None:
            self._log("Loop essential graph: non-finite solve; skipped")
            return False
        self.last_prealign.update(nodes=len(kfs), edges=len(e_i))
        self._log(
            f"Loop essential graph: {len(kfs)} nodes, {len(e_i)} edges"
        )

        # map points follow their reference keyframe's pose delta
        # (X' = T_new^-1 T_old X), then poses write back
        deltas = {}
        for i, kf in enumerate(kfs):
            deltas[kf] = (np.linalg.inv(T_new[i]) @ T_old[i]).astype(
                np.float32
            )
        by_ref: dict = {}
        for mp in self.map.all_map_points():
            if mp.is_bad or mp.ref_kf is None:
                continue
            D = deltas.get(mp.ref_kf)
            if D is None:
                continue
            by_ref.setdefault(id(mp.ref_kf), (D, []))[1].append(mp)
        for D, mps in by_ref.values():
            X = np.stack([mp.world_pos for mp in mps])
            Xc = X @ D[:3, :3].T + D[:3, 3]
            for mp, x in zip(mps, Xc):
                mp.set_world_pos(x.astype(np.float32))
        for i, kf in enumerate(kfs):
            if not fixed[i]:
                kf.set_pose(T_new[i])
        # normals/depths follow the moved geometry
        for mp in self.map.all_map_points():
            if not mp.is_bad:
                mp.update_normal_and_depth()
        return True

    def fuse_loop_duplicates(self) -> None:
        """Fuse the revisit keyframe's duplicate map points into the matched
        (old) keyframe side's points, creating real cross-loop observations
        (upstream ORB-SLAM2's loop SearchAndFuse, which the reference fork
        dropped: without it the global BA has no constraint tying the loop
        ends together). Like upstream, the fuse covers the matched keyframe
        and its best covisibles, in one batched matcher call.
        `SlamParameters.loopFuseDuplicates` (default True; False = strict
        fork-twin behavior).
        """
        targets = [self.matched_kf] + [
            kf
            for kf in self.matched_kf.get_best_covisibles(10)
            if not kf.is_bad
        ]
        results = self.matcher.match_against_many(self.current_kf, targets)
        pairs = []
        seen = set()
        for res in results:
            for i in range(res.num_matches):
                mp_new = res.get_map_point1(i)
                mp_old = res.get_map_point2(i)
                if (
                    mp_new is None
                    or mp_old is None
                    or mp_new is mp_old
                    or mp_new.is_bad
                    or mp_old.is_bad
                ):
                    continue
                key = (id(mp_new), id(mp_old))
                if key in seen:
                    continue
                seen.add(key)
                pairs.append((mp_new, mp_old))
        # Sim(3) chain pre-alignment from the duplicate pairs BEFORE fusing
        # (upstream CorrectLoop order: correct, then SearchAndFuse)
        if self.prealign:
            self._prealign_loop(pairs)
        n_fused = 0
        for mp_new, mp_old in pairs:
            if mp_new.is_bad or mp_old.is_bad:
                continue
            # the OLD point survives (it anchors the older, less-drifted
            # geometry and usually carries more observations)
            mp_new.replace(mp_old)
            n_fused += 1
        self.last_fuse_count = n_fused
        self._log(f"Loop fuse: {n_fused} duplicate map points merged")

    def run_global_bundle_adjustment(self, loop_kf_id: int) -> None:
        """Global BA + spanning-tree propagation (LoopClosing.cc:122-199).

        With loop fusion on, the BA must propagate a whole loop-gap
        correction down the keyframe chain from freshly fused, very large
        residuals: more LM steps and a deeper CG solve than the reference's
        polish-only schedule."""
        self._log("Starting Global Bundle Adjustment")
        if self.fuse_duplicates:
            run_global_ba(
                self.map, 25, self.device, robust=False, loop_kf=loop_kf_id,
                cg_iters=200,
            )
        else:
            run_global_ba(self.map, 10, self.device, robust=False, loop_kf=loop_kf_id)
        self._log("Global Bundle Adjustment finished")
        self._log("Updating map ...")

        # propagate corrections through the spanning tree (139-161)
        to_check = list(self.map.keyframe_origins)
        while to_check:
            kf = to_check.pop(0)
            Twc = kf.get_pose_inverse()
            for child in kf.children:
                if child.ba_global_for_kf != loop_kf_id:
                    t_child_c = child.get_pose() @ Twc
                    child.Tcw_gba = t_child_c @ kf.Tcw_gba
                    child.ba_global_for_kf = loop_kf_id
                to_check.append(child)
            kf.Tcw_bef_gba = kf.get_pose()
            kf.set_pose(kf.Tcw_gba)

        # map points: apply staged result or re-anchor via reference KF (163-192)
        for mp in self.map.all_map_points():
            if mp.is_bad:
                continue
            if mp.ba_global_for_kf == loop_kf_id:
                mp.set_world_pos(mp.pos_gba)
            else:
                ref = mp.ref_kf
                if ref.ba_global_for_kf != loop_kf_id:
                    continue
                Rcw = ref.Tcw_bef_gba[:3, :3]
                tcw = ref.Tcw_bef_gba[:3, 3]
                Xc = Rcw @ mp.world_pos + tcw
                Twc = ref.get_pose_inverse()
                mp.set_world_pos(Twc[:3, :3] @ Xc + Twc[:3, 3])

        self.map.inform_new_big_change()
        if self.local_mapper is not None:
            self.local_mapper.release()
        self._log("Map updated!")
