"""SLAM configuration.

A copy of `mono_slam_framework_tpu/params.py` (pure Python). Mirrors the
reference's ``SlamParameters`` struct (field names and defaults:
slam_pipeline/include/SlamParameters.h:7-35) and adds the static capacity
knobs a fixed-shape TPU pipeline needs (padded feature/match/map sizes choose
the compiled program shapes; they are capacities, not behavioral thresholds).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SlamParameters:
    # Camera intrinsics (SlamParameters.h:9).
    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0

    # Max/Min frames between keyframe insertions and relocalization checks
    # (SlamParameters.h:12-13).
    maxFrames: int = 10
    minFrames: int = 0

    # Min feature matches required to attempt initialization
    # (SlamParameters.h:16).
    minIniMatchCount: int = 25

    # Min feature matches for local tracking / lost check (SlamParameters.h:19).
    minLocalMatchCount: int = 15

    # Min keyframes in the map before a lost track triggers relocalization
    # instead of a full reset (SlamParameters.h:22).
    minimumKeyFrames: int = 5

    # Loop closing (SlamParameters.h:28-30).
    loopDetectionMaxFrames: int = 5
    minNumMPMatches: int = 15

    # Fuse the revisit keyframe's duplicate map points into the matched old
    # keyframe's points before the loop global BA (upstream ORB-SLAM2's
    # SearchAndFuse step, dropped by the reference fork — without it the
    # loop BA has no constraint tying the loop ends together and the
    # "correction" is a measured no-op: on the rect-loop hard world the
    # fork arm leaves ATE at 1.28 before==after while this arm pulls it
    # under 0.25; see QUIRKS.md "loop fuse default"). True (default) beats
    # the fork's broken behavior; False = strict reference-fork twin
    # (slam/loop_closing.py::fuse_loop_duplicates).
    loopFuseDuplicates: bool = True

    # With loopFuseDuplicates: before fusing and running the loop global
    # BA, measure the loop correction (robust Sim3 over the duplicate
    # map-point pairs, geometry/sim3.py::fit_sim3_robust) and distribute it
    # around the whole keyframe chain with an SE(3) essential-graph
    # optimization (optim/pose_graph.py) — upstream ORB-SLAM2's CorrectLoop
    # ordering (Sim3 -> SearchAndFuse -> OptimizeEssentialGraph), which the
    # reference fork dropped along with the Sim3 solver. Without it the GBA
    # starts a full loop-gap outside its convergence basin and is a measured
    # no-op (QUIRKS.md "loop fuse default").
    loopPrealignSim3: bool = True

    # Minimum parallax (cosine bound used for triangulation gating,
    # SlamParameters.h:34).
    minimumParallax: float = 1.1

    # Fused steady-state tracking: run the per-frame OK-path (extract +
    # match + associate + pose LM, then frustum + local-KF match + pose LM)
    # as two fixed-shape device programs with one readback each instead of
    # ~10 round trips (slam/fused_tracking.py). Semantics are replayed
    # reference-identically; falls back to the unfused path whenever its
    # preconditions fail (non-ORB matchers, reloc cooldown, ...). ON by
    # default: this is the framework's headline steady-state path; set False
    # for the strict reference-twin flow (parity is pinned either way by
    # tests/test_fused.py).
    fusedTracking: bool = True

    # On top of fusedTracking: collapse BOTH programs into ONE with a single
    # readback per steady frame (fused_tracking.steady_step). Candidate
    # filtering moves on-device and the local-keyframe window is the one
    # computed after the previous frame (one frame stale, refreshed after
    # the readback) — a deliberate, measured deviation from the reference
    # ordering; A/B'd against the two-program path by tests/test_fused.py.
    # ON by default (fastest host-in-the-loop mode).
    fusedOneStep: bool = True

    # Freshness floor for the fused steady paths, as a share of
    # max_features: when a one-step frame's FINAL local-map inlier count
    # falls below share*max_features the frame is discarded and re-tracked
    # through the reference host path, which rebuilds the local-KF window
    # from scratch. The one-step window is refreshed from each frame's own
    # tracked points, so when the camera turns into unmapped territory the
    # stale window starves the very matches that would refresh it — measured
    # on the rect-loop corner as a freeze-jump cycle the reference twin does
    # not show (tools/tpu_axis_probe.py, round 5: one-step ate 0.104 vs
    # unfused 0.047). Steady frames sit far above the floor (150-400
    # inliers at 2000 features), so the fallback only fires on the rare
    # degraded frame. 0 disables the gate.
    fusedInlierFloorShare: float = 0.06

    # Solve an essential graph in a background thread when the System is
    # built on a card, so that the first loop correction finds the solve's
    # one-time set-up paid (slam/device_io.prewarm_startup_shapes,
    # utils/prewarm.py; a no-op on the CPU). The JAX package warms its
    # compile cache's shape buckets here, on by default. OFF by default in
    # the port: on an H100 the warm's thread slowed a process's first
    # initialization by more than it saved its first loop correction
    # (chip_smoke phase startup, PERF.md).
    prewarmShapes: bool = False

    # Opt-in escape from the post-relocalization KF-insertion cooldown
    # (Tracking.cc:525-527 blocks insertion for maxFrames after reloc; with a
    # fast camera the map starves while inliers decay — KNOWN_ISSUES.md).
    # When > 0, a new keyframe may be inserted during the cooldown if tracked
    # inliers drop below this floor. 0 = reference behavior (default).
    relocCooldownInlierFloor: int = 0

    # ---- TPU static-shape capacities (new; no reference counterpart) ----
    # Max features extracted per frame (ORB front-end budget).
    max_features: int = 512
    # Max matches returned by a matcher call.
    max_matches: int = 512
    # RANSAC iterations for two-view initialization (Initializer.cc:36).
    ransac_iterations: int = 200
    # Retry the other two-view model (H<->F) when the selected one fails its
    # reconstruction gates (off = reference behavior: fail and retry next
    # frame; see QUIRKS.md).
    initializerModelFallback: bool = False
    # Measurement sigma for initializer scoring (Initializer.cc:31).
    sigma: float = 1.0
    # Weight optimization edges by the detection octave's InvSigma2
    # (1/1.2^(2*octave)) — upstream ORB-SLAM2 behavior that the reference
    # fork dropped (identity information at Optimizer.cc:141,265), a main
    # contributor to monocular scale drift (KNOWN_ISSUES.md). False restores
    # the fork's identity weighting.
    octaveInformation: bool = True

    def intrinsics(self):
        return (self.fx, self.fy, self.cx, self.cy)
