#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port's main path.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and this
checkout; it exits non-zero without either. Each phase prints one JSON
line and raises if it fails:

  1. device   — nvidia-smi name / power limit, torch and CUDA versions;
  2. build    — nvcc builds csrc/*.cu into the kernel library; fails if
                ptxas reports a stack frame or a spill for kernel B2;
  3. b1       — kernel B1 (detection maps) against its plain version on a
                rendered 640x480 view, per level on interior pixels;
  4. b2       — kernel B2 (pose LM) against its plain version on a seeded
                pose problem with 2000 edges, outliers, padding and info, on
                a steady-step-shaped one (2000 slots under a keep mask), on
                a batch of 3 with different padding and cameras, and on
                50,000 slots (past shared memory: read from device memory);
  5. extract  — orb.extract through B1 against the plain path, by feature set;
     hamming  — the bf16 Hamming distance matrix bit-equal to the f32 product
                on the card at the steady shapes, and both forms' times;
  6. slice    — 40 chained frames of fused_tracking.steady_step at 640x480,
                2000 features, 8 local keyframes and tables of 1024, on a map
                seeded from the simulator's geometry; checks launch counts,
                poses against ground truth and against the same drive with
                both kernels replaced by their plain versions, and times it;
  7. kernel_times — B1 and B2 alone at main-path shapes: the bare launch
                (the C entry point on prepared device tensors, many launches
                between two CUDA events over their count), the wrapper the
                same way, and the plain version; then b2_cluster_sweep, B2's
                bare time at each cluster size it is built for;
  8. b1_per_level — the one-level launches of B1 (the Hopper form of the
                JAX package's per-level B1-banded / B1-full kernels) against
                level_maps_plain at every level of a 640x480 and a 240x320
                view, orb.extract(per_level=True) against the one-launch
                extract feature for feature, and the per-level path's launch
                counts and times;
  9. system   — System.track_monocular in the reference-twin flow
                (fusedTracking=False: two-view initialization, tracking,
                local mapping with BA, loop detection) over 42 frames at
                640x480 and 2000 features, 12 warm then 30 timed: frames/s,
                latency, stage split, launches, ATE; then the same drive with
                both kernels replaced by their plain versions;
 10. system_fused — the same drive with SlamParameters' defaults, the fused
                one-step flow (slam/fused_host.py), through the kernels and
                through their plain versions: frames completed by run_steady,
                run and the host path, fallbacks by reason, launches per
                run_steady frame (B1 once, B2 twice), ATE, the trajectory
                pair against the `system` drive;
 11. system_pipelined — the same through track_monocular_pipelined and
                flush_pipeline, every dispatch_steady_spec under
                torch.cuda.set_sync_debug_mode("error"): hits, misses,
                skips, process / dispatch ms, the pair against system_fused;
 12. system_fused_kf — the fused flow at step 0.06, 8 warm + 30 timed
                frames: keyframe events, context rebuilds and local BA inside
                the timed window;
 13. reloc_loop — the JAX package's quality drive (the hard world at
                320x240, 2000 features, the 141-pose rect loop) with two flat
                frames after frame 10, in the default fused flow: the loss and
                its relocalization (EPnP, then B2), the OK share, the keyframe
                poses, B1 / B2 launches, frames/s, and whether the genuine loop
                fired (with the ATE just before and after its correction);
                then test_reloc_loop.py's deterministic loop at 2000 features
                with pre-alignment off (the staged-GBA invariants) and on (a
                drifted revisit: the Sim(3) fit and the essential graph run
                and move the revisit toward its place), the fused ctx rebuilt
                after each correction. The map drawer's update time
                (the tracker calls it on every OK frame) is reported here and
                in every System phase; system_fused's map goes through a
                checkpoint round trip (phase checkpoint).
 14. loftr_model — the LoFTR coarse model on the card at 480x640 on
                tests/test_loftr.py's rendered pair: the f32 confidence
                against the CPU's (< 1e-5, argmax > 0.999), the card's bf16
                path against its f32 one (max |d|, argmax agreement, the
                above-threshold sets), match_against_many against serial
                match_frames, fine_refine's offsets bf16 against f32, and
                CUDA-event times of encode, one pairwise
                confidence_from_features and match_one_against_many at N = 8;
 15. system_loftr, system_loftr_fused, system_loftr_pipelined — the System
                regime of phase 9 with LoftrFeatureMatcher(threshold=0.1,
                fine=False), minIniMatchCount=60: the reference-twin flow, the
                one-step fused_loftr path and the pipelined mode (dispatches
                under the sync debug mode), each followed by 5 frames under
                torch.profiler (copies and synchronizations per frame); the
                trajectory pairs fused / unfused and pipelined / fused;
 16. b2_loftr   — kernel B2 against its plain version on a 1200-slot problem
                taken from the fused LoFTR step (the coarse-cell information
                weight), and its bare, wrapper and plain times;
 17. quality_loftr — quality_bench.run_quality_loftr's drive (the smooth
                rect-loop world at 320x240, 40 poses, LoFTR at threshold
                0.1): OK share, ATE, keyframes, map points, batched database
                matches.
 18. native   — g++ builds the native observation graph and frame IO
                (native/*.cc) into _build/; the graph's raw API. Fails if
                either does not build: the System would then scan
                covisibility in Python and the loaders decode with PIL;
 19. run_cli  — phase 9's 42 frames written as 8-bit grayscale PNGs (a zlib
                encoder here) into a TUM directory, then run.main in-process
                at 640x480 / 2000 features, in the default fused flow and
                with --pipelined: the printed summary (42 frames, >= 2
                keyframes, OK, keyframe ATE within MAX_CLI_ATE), the
                --map-out checkpoint reloaded with the map's counts, the
                native graph in the System, B1 / B2 launched by the drive;
                which decoder served the frames and its ms per frame with the
                prefetcher and without;
 20. ab_sweep — ab_sweep.main over the same directory with ORB and LoFTR
                (both in the reference-twin flow, as the JAX harness runs
                them): both arms end OK; frames/s and ATE per arm;
 21. interactive — interactive.main's scripted session at 640x480 / 2000
                features (OK, >= 2 keyframes, no frame dropped), then 40
                frames fed every 32 ms through AsyncSlamDriver while its
                worker tracks: frames dropped, final state; an exception in
                any worker thread fails the phase;
 22. quality_bench — the port's quality_bench.run_quality (both arms, 141
                poses) and run_quality_loftr on the card: no error key, ORB
                OK share >= 0.8; the loop and the fork arm recorded;
 23. kf_graph — system_fused_kf's drive with Map(use_native_graph=True) and
                with the Python scan, in turns: keyframe-event p50 / p95,
                update_connections ms per call, and whether the drives built
                the same map (pose checksums).
 24. b1_batch, b2_batch — kernel B1 over 4 streams in one launch (each
                stream bit-equal to its one-stream launch, all against the
                plain version) and B2 over 8 steady-shaped problems against
                its plain version;
 25. multistream — parallel/multistream.py's steady_step_batch over 8
                streams at 640x480, 2000 features, tables of 1024 and 8 local
                keyframes (bench.py::bench_multistream's regime on seeded
                maps): 30 timed calls after one warm-up and the same inputs
                as 8 one-stream steady_step calls per frame, in turns;
                aggregate and per-stream frames/s, device ops per call; every
                stream of every call against its one-stream step (rows and
                n_good equal, T1 / T2 within 1e-4), the batch against its
                plain kernels; one B1 and two B2 launches per call; the
                batched launches' bare times at N = 1, 4, 8;
 26. server, server_pipelined, server_loftr — parallel/server.py's
                SlamServer over bench.py::bench_server's regime (4 streams,
                640x480, steps 0.02 + 0.004 s, 10 warm + 24 timed ticks, ORB
                at 2000 features; then LoftrFeatureMatcher(threshold=0.1,
                fine=False) at steps 0.02 + 0.001 s), step and step_pipelined
                (ORB; every dispatch of the pipelined drive under
                torch.cuda.set_sync_debug_mode("error")): aggregate
                frames/s, tick p50 / p95, the batched share, prepare /
                dispatch / readback / track ms per tick, launches; every
                stream OK, ATE < 0.15 and within 0.05 of the same stream run
                as an independent System (LoFTR: 0.2 and 0.06), every
                batched dispatch consumed.

The last three lines are the kernels' JSON summary, the card's name and
power limit, and {"ok": true, "device": {...}}.

The world seeding (`seed_map`), the drives (`drive`, `run_system`) and the
checks take a device and a size, so the CPU tests run them at a small size.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import pathlib
import re
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import zlib
from typing import NamedTuple
from unittest import mock

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import mono_slam_framework_torch.slam as slam_pkg  # noqa: E402
from mono_slam_framework_torch import _kernels, convert, native, sim  # noqa: E402
from mono_slam_framework_torch import ab_sweep, interactive, quality_bench  # noqa: E402
from mono_slam_framework_torch import run as runner  # noqa: E402
from mono_slam_framework_torch.io import datasets  # noqa: E402
from mono_slam_framework_torch.geometry import se3  # noqa: E402
from mono_slam_framework_torch.io import trajectory  # noqa: E402
from mono_slam_framework_torch.matchers import LoftrFeatureMatcher, OrbFeatureMatcher  # noqa: E402
from mono_slam_framework_torch.models import loftr_native  # noqa: E402
from mono_slam_framework_torch.native import frameio  # noqa: E402
from mono_slam_framework_torch.ops import detect, hamming, orb  # noqa: E402
from mono_slam_framework_torch.optim import pose_opt, pose_opt_cuda  # noqa: E402
from mono_slam_framework_torch.parallel import SlamServer, multistream  # noqa: E402
from mono_slam_framework_torch.params import SlamParameters  # noqa: E402
from mono_slam_framework_torch.slam import KeyFrameMatchDatabase, System  # noqa: E402
from mono_slam_framework_torch.slam import fused_host, fused_loftr, fused_tracking  # noqa: E402
from mono_slam_framework_torch.slam import map_model  # noqa: E402
from mono_slam_framework_torch.slam import system as system_mod  # noqa: E402
from mono_slam_framework_torch.slam.frame import reset_frame_ids  # noqa: E402
from mono_slam_framework_torch.slam.map_model import MapPoint, reset_map_ids  # noqa: E402
from mono_slam_framework_torch.utils import AsyncSlamDriver  # noqa: E402

RATIO = 0.7
FAST_THRESHOLD = 20.0
# the kernels' design, reported in the kernels line: B2 as a cluster of CTAs
# per problem, B1 in 32x64 tiles (before them: one block per B2 problem, 32x32
# B1 tiles)
DESIGN = "B2 cluster, B1 32x64 tiles"


class Config(NamedTuple):
    h: int
    w: int
    f: float
    max_features: int
    n_kf: int  # local keyframes (the fixed window)
    cap: int  # table capacities M = R = P = M2
    n_frames: int  # tracked frames after the keyframes
    step: float  # lateral_trajectory step


# the repo's steady operating point (bench.py::bench_steady_device)
FULL = Config(480, 640, 500.0, 2000, 8, 1024, 40, 0.02)
# the sizes of __graft_entry__.entry, for the CPU tests
SMALL = Config(240, 320, 250.0, 512, 4, 256, 6, 0.02)

# Bounds of the FULL drive: three times the worst error of the same drive
# run with the plain versions on a CPU (worst camera-centre error 0.00953 m,
# rotation 0.0896 deg; lowest second-LM n_good 353).
MAX_CENTER_ERR = 0.0286  # metres
MAX_ROT_ERR_DEG = 0.269
MIN_N_GOOD2 = 175  # half the lowest CPU value


def render(cfg: Config):
    """(world, ground-truth poses, images) for keyframes + tracked frames, in
    the plane world of bench.py's system runs at the config's size."""
    world = sim.PlaneWorld(width=cfg.w, height=cfg.h, f=cfg.f, second_plane=(3.0, 0.3))
    poses = sim.lateral_trajectory(cfg.n_kf + cfg.n_frames, step=cfg.step)
    return world, poses, [world.render(T) for T in poses]


def back_project(world: sim.PlaneWorld, Tcw: np.ndarray, xy: np.ndarray):
    """World points seen at pixels xy [N,2] from pose Tcw: the ray-plane
    logic of PlaneWorld.render."""
    Rwc = Tcw[:3, :3].astype(np.float64).T
    Ow = -Rwc @ Tcw[:3, 3].astype(np.float64)
    d_cam = np.stack(
        [(xy[:, 0] - world.cx) / world.f, (xy[:, 1] - world.cy) / world.f,
         np.ones(len(xy))], axis=-1,
    )
    d = d_cam @ Rwc.T
    dz = np.where(np.abs(d[:, 2]) < 1e-9, 1e-9, d[:, 2])
    t = (world.plane_z - Ow[2]) / dz
    for z2, th, ax in world.extra_planes:
        t2 = (z2 - Ow[2]) / dz
        p2 = Ow[None, :2] + t2[:, None] * d[:, :2]
        use2 = {"x": p2[:, 0] > th, "-x": p2[:, 0] < th,
                "y": p2[:, 1] > th, "-y": p2[:, 1] < th}[ax]
        t = np.where(use2, t2, t)
    return Ow + t[:, None] * d, Ow


class SeedMap(NamedTuple):
    feats: list  # per-keyframe Features
    kf_feats: orb.Features  # stacked [N, K, ...]
    kf_px: torch.Tensor
    kf_row: torch.Tensor
    mp_pos: torch.Tensor
    first_slot: torch.Tensor
    normal: torch.Tensor
    maxdist: torch.Tensor
    K: torch.Tensor


def seed_tables(cfg: Config, world, poses, kf_xy, kf_valid) -> dict:
    """The local map from the simulator's geometry, in place of two-view
    initialization: up to cap / n_kf valid keypoints of each keyframe
    (numpy xy [K,2] and valid [K] per keyframe) are back-projected onto the
    world's planes at the ground-truth pose. Returns numpy tables: mp_pos,
    first_slot, normal, maxdist, kf_px, kf_row."""
    per_kf = cfg.cap // cfg.n_kf
    t = {
        "mp_pos": np.zeros((cfg.cap, 3), np.float32),
        "first_slot": np.full(cfg.cap, -1, np.int32),
        "normal": np.zeros((cfg.cap, 3), np.float32),
        "maxdist": np.zeros(cfg.cap, np.float32),
        "kf_px": np.full((cfg.n_kf, cfg.cap), -1, np.int32),
        "kf_row": np.full((cfg.n_kf, cfg.cap), -1, np.int32),
    }
    for k in range(cfg.n_kf):
        slots = np.nonzero(kf_valid[k])[0]
        slots = np.unique(slots[np.linspace(0, len(slots) - 1, per_kf).round().astype(int)])
        xy = kf_xy[k][slots].astype(np.float64)
        X, Ow = back_project(world, poses[k], xy)
        rows = k * per_kf + np.arange(len(slots))
        PO = X - Ow
        dist = np.linalg.norm(PO, axis=1)
        t["mp_pos"][rows] = X
        t["first_slot"][rows] = k
        t["normal"][rows] = PO / dist[:, None]
        t["maxdist"][rows] = 1.5 * dist
        xy_i = xy.astype(np.int32)  # truncation, as the matcher contract
        t["kf_px"][k, : len(slots)] = xy_i[:, 1] * cfg.w + xy_i[:, 0]
        t["kf_row"][k, : len(slots)] = rows
    return t


def seed_map(device, cfg: Config, world, poses, images) -> SeedMap:
    """Extract the keyframes with the port and seed the map from the
    simulator's geometry (`seed_tables`), on `device`."""
    feats = [
        orb.extract(torch.from_numpy(images[k]).to(device), cfg.max_features,
                    FAST_THRESHOLD)
        for k in range(cfg.n_kf)
    ]
    t = seed_tables(
        cfg, world, poses, [f.xy.cpu().numpy() for f in feats],
        [f.valid.cpu().numpy() for f in feats],
    )
    t = {k: torch.from_numpy(v).to(device) for k, v in t.items()}
    return SeedMap(
        feats=feats,
        kf_feats=orb.Features(*(torch.stack(xs) for xs in zip(*feats))),
        K=torch.from_numpy(world.K).to(device),
        **t,
    )


class Drive(NamedTuple):
    T2: np.ndarray  # [n_frames, 4, 4] tracked poses
    n_good2: np.ndarray  # [n_frames] second-LM inliers
    frame_ms: np.ndarray  # [n_frames] CUDA-event ms per frame (empty on CPU)


def drive(device, cfg: Config, seed: SeedMap, poses, images) -> Drive:
    """Track frames n_kf .. n_kf + n_frames - 1 with steady_step, chained as
    the pipelined host mode chains it: each frame's features, chain_px and
    union_row become the next frame's prev tables, and T_init comes from
    chain_T_init(T2, T_prev). Frame n_kf starts from the last keyframe."""
    last = cfg.n_kf - 1
    imgs = [torch.from_numpy(images[i]).to(device)
            for i in range(cfg.n_kf, cfg.n_kf + cfg.n_frames)]
    prev_feats = seed.feats[last]
    prev_px, prev_row = seed.kf_px[last], seed.kf_row[last]
    T_prev = torch.from_numpy(poses[last]).to(device)
    T_prev2 = torch.from_numpy(poses[last - 1]).to(device)
    timed = device.type == "cuda"
    events, T2s, n_goods = [], [], []
    for img in imgs:
        T_init = fused_tracking.chain_T_init(T_prev, T_prev2)
        if timed:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        out = fused_tracking.steady_step(
            img, prev_feats, prev_px, prev_row, seed.mp_pos, T_init,
            seed.kf_feats, seed.kf_px, seed.kf_row, seed.first_slot,
            seed.normal, seed.maxdist, seed.K, RATIO, cfg.w, float(cfg.w),
            float(cfg.h), True, cfg.max_features, FAST_THRESHOLD,
        )
        if timed:
            ev[1].record()
            events.append(ev)
        prev_feats, prev_px, prev_row = out.cur, out.chain_px, out.union_row
        T_prev2, T_prev = T_prev, out.local.T2
        T2s.append(out.local.T2)
        n_goods.append(out.local.n_good)
    if timed:
        torch.cuda.synchronize(device)
    ms = np.asarray([a.elapsed_time(b) for a, b in events])
    return Drive(
        torch.stack(T2s).cpu().numpy(),
        torch.stack(n_goods).cpu().numpy(),
        ms,
    )


def pose_errors(T_est: np.ndarray, T_gt: np.ndarray):
    """(camera-centre error [m], rotation error [deg]) per frame."""
    def centre(T):
        return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])

    T_est, T_gt = T_est.astype(np.float64), T_gt.astype(np.float64)
    c_err = np.linalg.norm(centre(T_est) - centre(T_gt), axis=1)
    dR = np.einsum("nij,nkj->nik", T_est[:, :3, :3], T_gt[:, :3, :3])
    cos = np.clip((np.trace(dR, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return c_err, np.degrees(np.arccos(cos))


@contextlib.contextmanager
def plain_kernels():
    """Route the main path through both kernels' plain versions (for the
    comparison drive on the card), the batched launches included."""
    with mock.patch.object(detect, "detect_maps", detect.detect_maps_plain), \
            mock.patch.object(detect, "detect_maps_batch", detect.detect_maps_batch_plain), \
            mock.patch.object(pose_opt, "pose_optimize", pose_opt.pose_optimize_plain), \
            mock.patch.object(pose_opt, "pose_optimize_batched", pose_opt.pose_lm_batched_plain):
        yield


def pose_problem(seed: int = 0, n: int = 2000, n_outliers: int = 100,
                 n_pad: int = 64, f: float = 500.0, c=(320.0, 240.0)):
    """A seeded motion-only pose problem (test_optim.make_pose_problem's
    construction) with outliers, padded edges and per-edge info, seen by a
    camera of focal length f and principal point c; numpy."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4, 10, n)], -1)
    exp = lambda xi: se3.exp_se3(torch.from_numpy(xi)).numpy()  # noqa: E731
    xi_true = rng.normal(size=6) * 0.1
    T_true = exp(xi_true)
    Xc = X @ T_true[:3, :3].T + T_true[:3, 3]
    uv = (Xc[:, :2] / Xc[:, 2:]) * f + np.asarray(c)
    uv = uv + rng.normal(0, 0.8, uv.shape)
    idx = rng.choice(n - n_pad, n_outliers, replace=False)
    uv[idx] += rng.uniform(30, 120, (n_outliers, 2)) * rng.choice([-1, 1], (n_outliers, 2))
    T0 = exp(xi_true + rng.normal(size=6) * 0.05)
    valid = np.ones(n, bool)
    valid[n - n_pad:] = False
    X[~valid] = 0.0
    uv[~valid] = 0.0
    info = rng.uniform(0.5, 1.5, n)
    K = np.array([[f, 0, c[0]], [0, f, c[1]], [0, 0, 1]])
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return f32(T0), f32(X), f32(uv), valid, f32(K), f32(info)


def steady_problem(seed: int = 5, n: int = 2000, keep_share: float = 0.3):
    """A pose problem shaped as the steady step hands it to B2: n feature
    slots of which a scattered `keep_share` are associated (valid); the
    other slots carry junk map positions, as `mp_pos[clamp(row, 0)]` does."""
    T0, X, uv, _, K, info = pose_problem(seed, n, n_outliers=int(0.05 * n), n_pad=0)
    rng = np.random.default_rng(seed + 1)
    valid = rng.random(n) < keep_share
    X[~valid] = X[0]
    return T0, X, uv, valid, K, info


def _cuda_ms(fn, n: int = 20) -> float:
    """Median of n CUDA-event timings of fn() after one warm-up call."""
    fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _per_launch_ms(fn, n: int = 200, reps: int = 5) -> float:
    """ms per call of fn: n calls back to back between two CUDA events,
    elapsed / n, median over reps (after 3 warm-up calls). The device runs
    one call after another, so this is the device time of a call unless
    the host issues it more slowly (then it is the host's)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def b1_bare(stack, dims):
    """A closure that launches B1 through its C entry point (what
    detect._launch calls, detect_maps_batch_launch) on prepared device
    inputs and outputs: no checks, no allocation, no count. `stack` is one
    [rows, w0] level stack or N streams' [N, rows, w0] (one launch over all
    of them)."""
    dims = tuple(dims)
    stacks = stack if stack.dim() == 3 else stack[None]
    n = stacks.shape[0]
    _, rows, w0 = detect.level_layout(dims)
    (gx, gy), table = detect.tile_plan(dims).grid, detect._device_table(dims, stack.device)
    out = torch.empty((5, n, rows, w0), dtype=torch.float32, device=stack.device)
    lib = _kernels.load()
    args = (stacks.data_ptr(), out.data_ptr(), table.data_ptr(), len(dims), gx, gy, n, rows,
            w0, FAST_THRESHOLD, orb.BORDER, _kernels.stream_ptr(stack.device))
    owners = (stacks, table, out)  # kept alive by the closure
    return lambda: (owners, lib.detect_maps_batch_launch(*args))[1]


def b2_bare(T0, X, uv, valid, K, info, cluster: int = pose_opt_cuda.CLUSTER):
    """A closure that launches B2 through its C entry point (what
    pose_opt_cuda.pose_lm_batched calls) on one prepared problem, or on B
    problems with a leading axis B: no checks, no allocation, no count."""
    dev = X.device
    lead = X.shape[:-2]
    E = X.shape[-2]
    plan = pose_opt_cuda.lm_plan(E, cluster)
    t = [X, uv, valid, info, K, T0, torch.empty((*lead, 4, 4), dtype=torch.float32, device=dev),
         torch.empty((*lead, E), dtype=torch.bool, device=dev),
         torch.empty(lead, dtype=torch.int32, device=dev)]
    lib = _kernels.load()
    args = (*(x.data_ptr() for x in t), int(np.prod(lead)), E, *plan, _kernels.stream_ptr(dev))
    return lambda: (t, lib.pose_lm_launch(*args))[1]


# ---------------------------------------------------------------------------
# checks shared by main() and the cuda-marked tests


def check_b1(img: np.ndarray, device):
    """Kernel B1 against detect_maps_plain on the card, per level, on
    interior pixels, with the Pallas-vs-XLA tolerances of
    tests/test_pallas_detect.py. Returns the phase record."""
    dims = orb._level_dims(*img.shape)
    stack = orb.pyramid(torch.from_numpy(img).to(device))
    got = detect.detect_maps_cuda(stack, dims, FAST_THRESHOLD, orb.BORDER)
    ref = detect.detect_maps_plain(stack, dims, FAST_THRESHOLD, orb.BORDER)
    torch.cuda.synchronize(device)
    return {"phase": "b1", **b1_against_plain(got, ref, dims)}


def b1_against_plain(got, ref, dims) -> dict:
    """B1's maps of one stack against the plain version's, per level on
    interior pixels, with check_b1's tolerances; raises past them."""
    got = [m.cpu().numpy() for m in got]
    ref = [m.cpu().numpy() for m in ref]
    tol = {"score": (1e-5, 1e-2), "m10": (1e-4, 2.0), "m01": (1e-4, 2.0),
           "blur": (1e-5, 1e-3), "harris": (5e-4, 1.0)}
    row0, _, _ = detect.level_layout(dims)
    flips = n_interior = 0
    max_err = {k: 0.0 for k in tol}
    failures = []
    for lvl, ((h, w), r) in enumerate(zip(dims, row0)):
        m = np.zeros((h, w), bool)
        m[orb.BORDER: h - orb.BORDER, orb.BORDER: w - orb.BORDER] = True
        n_interior += int(m.sum())
        gs, rs = got[0][r: r + h, :w], ref[0][r: r + h, :w]
        # NMS ties resolved differently by reassociated sums flip a pixel
        flips += int((np.isfinite(gs) != np.isfinite(rs))[m].sum())
        for i, name in enumerate(tol):
            g, rf = got[i][r: r + h, :w][m], ref[i][r: r + h, :w][m]
            fin = np.isfinite(g) & np.isfinite(rf)
            rtol, atol = tol[name]
            bad = int((np.abs(g[fin] - rf[fin]) > atol + rtol * np.abs(rf[fin])).sum())
            if bad:
                failures.append(f"{name} level {lvl}: {bad} pixels off")
            if fin.any():
                max_err[name] = max(max_err[name], float(np.abs(g[fin] - rf[fin]).max()))
        # pad columns: score -inf, the rest 0, in both
        for i in range(5):
            np.testing.assert_array_equal(got[i][r: r + h, w:], ref[i][r: r + h, w:])
    rec = {"score_flips": flips, "interior_px": n_interior, "max_abs_err": max_err}
    if failures or flips > 0.001 * n_interior:
        raise AssertionError(f"B1 differs from its plain version: {failures} {rec}")
    return rec


def check_b1_batch(imgs: np.ndarray, device) -> dict:
    """Kernel B1 over N streams in one launch: each stream's maps equal the
    one-stream launch's bit for bit (the same kernel, the stream on
    blockIdx.z), and are held against the plain version with check_b1's
    tolerances."""
    dims = orb._level_dims(*imgs.shape[1:])
    stacks = torch.stack([orb.pyramid(torch.from_numpy(img).to(device)) for img in imgs])
    got = detect.detect_maps_batch_cuda(stacks, dims, FAST_THRESHOLD, orb.BORDER)
    ref = detect.detect_maps_batch_plain(stacks, dims, FAST_THRESHOLD, orb.BORDER)
    one = [detect.detect_maps_cuda(stacks[i].contiguous(), dims, FAST_THRESHOLD, orb.BORDER)
           for i in range(len(imgs))]
    torch.cuda.synchronize(device)
    equal = all(torch.equal(a[i], b) for i, maps in enumerate(one) for a, b in zip(got, maps))
    per = [b1_against_plain([m[i] for m in got], [m[i] for m in ref], dims)
           for i in range(len(imgs))]
    rec = {"phase": "b1_batch", "streams": len(imgs), "equal_to_one_stream_launches": equal,
           "score_flips": sum(r["score_flips"] for r in per),
           "max_abs_err": {k: max(r["max_abs_err"][k] for r in per) for k in per[0]["max_abs_err"]}}
    if not equal:
        raise AssertionError(f"the batched B1 launch differs from one-stream launches: {rec}")
    return rec


def b2_batch_problems():
    """Three pose problems of 1500 slots with 0, 200 and 700 padded slots
    and three cameras, stacked [3, ...] (numpy)."""
    probs = [pose_problem(seed, 1500, 80, pad, f, c) for seed, pad, f, c in (
        (1, 0, 500.0, (320.0, 240.0)), (2, 200, 420.0, (300.0, 250.0)),
        (3, 700, 610.0, (330.0, 230.0)))]
    return [np.stack(xs) for xs in zip(*probs)]


def compare_b2(got, ref, what: str) -> dict:
    """Kernel B2's (T, inlier, n_good) against its plain version's, with the
    tolerances of tests/test_optim.py's Pallas-vs-XLA check: T atol 1e-4,
    inlier agreement > 0.98, n_good +- 2."""
    (T_k, in_k, ng_k), (T_p, in_p, ng_p) = ([x.cpu() for x in r] for r in (got, ref))
    rec = {"T_max_abs_err": float((T_k - T_p).abs().max()),
           "inlier_agreement": float((in_k == in_p).float().mean()),
           "n_good": ng_k.tolist(), "n_good_plain": ng_p.tolist()}
    if not (rec["T_max_abs_err"] <= 1e-4 and rec["inlier_agreement"] > 0.98
            and int((ng_k.long() - ng_p.long()).abs().max()) <= 2):
        raise AssertionError(f"B2 differs from its plain version ({what}): {rec}")
    return rec


def check_b2(device):
    """Kernel B2 against its plain version on the card: one problem at 2000
    edges, one shaped as the steady step hands it over (2000 slots under a
    keep mask), a batch of B = 3 problems with different padding and cameras
    through the batched launcher, and one of 50,000 slots, more than the
    shared memory of a cluster of 8 or of 1 holds."""
    rec = {"phase": "b2"}
    for name, prob in (("edges_2000", pose_problem()), ("steady_2000_slots", steady_problem())):
        args = [torch.from_numpy(a).to(device) for a in prob]
        rec[name] = compare_b2(pose_opt_cuda.pose_optimize_cuda(*args),
                               pose_opt.pose_optimize_plain(*args), name)
        rec[name]["valid_share"] = float(prob[3].mean())
    batch = [torch.from_numpy(a).to(device) for a in b2_batch_problems()]
    rec["batch_3"] = compare_b2(pose_opt_cuda.pose_lm_batched(*batch),
                                pose_opt.pose_lm_batched_plain(*batch), "batch of 3")
    # more slots than shared memory holds: the rest are read from device memory
    big = [torch.from_numpy(a).to(device) for a in pose_problem(4, 50_000, 2500, 1000)]
    ref = pose_opt.pose_optimize_plain(*big)
    for c in (pose_opt_cuda.CLUSTER, 1):
        plan = pose_opt_cuda.lm_plan(50_000, c)
        got = pose_opt_cuda.pose_lm_batched(*(a[None] for a in big), cluster=c)
        rec[f"edges_50000_cluster_{c}"] = {
            **compare_b2([x[0] for x in got], ref, f"50,000 slots, cluster {c}"),
            "device_memory_slots_per_cta": plan.slice - plan.resident}
    return rec


def b2_batch_problems_steady(n: int):
    """n steady-shaped pose problems of 2000 slots (steady_problem with seeds
    5 ..), stacked [n, ...] (numpy): the multi-stream step's LM batch."""
    return [np.stack(xs) for xs in zip(*(steady_problem(seed=5 + 2 * i) for i in range(n)))]


def check_b2_batch(device, n: int) -> dict:
    """Kernel B2 over B = n steady-shaped problems in one launch against its
    plain version (compare_b2's bounds)."""
    args = [torch.from_numpy(a).to(device) for a in b2_batch_problems_steady(n)]
    rec = compare_b2(pose_opt_cuda.pose_lm_batched(*args), pose_opt.pose_lm_batched_plain(*args),
                     f"batch of {n} steady problems")
    return {"phase": "b2_batch", "problems": n, **rec}


def b2_cluster_sweep(device):
    """Kernel B2 at every cluster size it is built for: each against the
    plain version, then its bare launch time at 2000 edges, at the steady
    step's shape, and at 16 edges (the chain of 44 reductions and 40 solves
    with next to no edge work: the kernel's floor)."""
    probs = {"edges_2000": pose_problem(), "steady_2000_slots": steady_problem(),
             "edges_16": pose_problem(n=16, n_outliers=0, n_pad=0)}
    args = {k: [torch.from_numpy(a).to(device) for a in v] for k, v in probs.items()}
    ref = pose_opt.pose_optimize_plain(*args["edges_2000"])
    ms = {k: {} for k in probs}
    for c in pose_opt_cuda.CLUSTERS:
        got = pose_opt_cuda.pose_lm_batched(*(a[None] for a in args["edges_2000"]), cluster=c)
        compare_b2([x[0] for x in got], ref, f"cluster {c}")
        for k, a in args.items():
            ms[k][c] = _per_launch_ms(b2_bare(*a, cluster=c))
    return {"phase": "b2_cluster_sweep", "threads_per_cta": pose_opt_cuda.THREADS,
            "bare_ms": ms, "fastest_at_2000": min(ms["edges_2000"], key=ms["edges_2000"].get),
            "default": pose_opt_cuda.CLUSTER}


def check_hamming(device) -> dict:
    """Phase hamming (ROADMAP C.9): the bf16 Hamming distance matrix against
    the f32 product of the same bits on the card, bit for bit, at the steady
    shapes (2000 x 2000, and 2000 against a stack of 8 keyframes' 2000),
    with invalid rows; then both forms' CUDA-event times."""
    rng = np.random.default_rng(9)
    rec = {"phase": "hamming"}
    for name, lead in (("pair", ()), ("stack_8", (8,))):
        d1 = torch.from_numpy(rng.integers(-2**31, 2**31, (2000, 8), dtype=np.int64)
                              .astype(np.int32)).to(device)
        d2 = torch.from_numpy(rng.integers(-2**31, 2**31, (*lead, 2000, 8), dtype=np.int64)
                              .astype(np.int32)).to(device)
        v1 = torch.from_numpy(rng.random(2000) < 0.95).to(device)
        v2 = torch.from_numpy(rng.random((*lead, 2000)) < 0.95).to(device)

        def f32_form():
            b1, b2 = hamming.unpack_bits(d1), hamming.unpack_bits(d2)
            d = b1.sum(-1)[:, None] + b2.sum(-1)[..., None, :] - 2.0 * (b1 @ b2.transpose(-1, -2))
            return torch.where(v1[:, None] & v2[..., None, :], d, torch.inf)

        got = hamming.distance_matrix(d1, d2, v1, v2)
        ref = f32_form()
        rec[name] = {"equal": bool(torch.equal(got, ref)),
                     "ms": _cuda_ms(lambda: hamming.distance_matrix(d1, d2, v1, v2)),
                     "f32_ms": _cuda_ms(f32_form)}
        if not rec[name]["equal"]:
            raise AssertionError(f"the bf16 Hamming distances differ from f32 ({name})")
    return rec


def feature_set_agreement(fa: dict, fb: dict):
    """How far two feature sets (dicts of numpy arrays with the Features
    fields, desc as uint32 words) agree, slot order aside: valid keypoints
    keyed on (x, y, octave) to 1 decimal (the pyramid's float reassociation).
    Returns (share of keypoints in common, share of common descriptors
    bit-identical, largest Hamming distance between common descriptors)."""
    def keyed(f):
        return {(round(float(f["xy"][i, 0]), 1), round(float(f["xy"][i, 1]), 1),
                 int(f["octave"][i])): f["desc"][i]
                for i in np.nonzero(f["valid"])[0]}

    a, b = keyed(fa), keyed(fb)
    common = set(a) & set(b)
    d = np.asarray([int(np.bitwise_count(a[k] ^ b[k]).sum()) for k in common], np.int64)
    share = len(common) / max(len(a), len(b), 1)
    return share, float((d == 0).mean()) if len(d) else 0.0, int(d.max()) if len(d) else 0


def check_extract(img: np.ndarray, device, max_features: int):
    """orb.extract through B1 against the plain path, by feature set: at
    least 95 % keypoints in common, 90 % of their descriptors identical, none
    more than 16 bits apart (tests/test_pallas_detect.py:114-165)."""
    t = torch.from_numpy(img).to(device)
    f_k = convert.features_to_numpy(orb.extract(t, max_features, FAST_THRESHOLD))
    with plain_kernels():
        f_p = convert.features_to_numpy(orb.extract(t, max_features, FAST_THRESHOLD))
    share, same, worst = feature_set_agreement(f_k, f_p)
    if share < 0.95 or same < 0.9 or worst > 16:
        raise AssertionError(f"extract: common {share}, identical {same}, max bits {worst}")
    return {"phase": "extract", "keypoints": int(f_k["valid"].sum()), "common_share": share,
            "identical_desc_share": same, "max_desc_bits": worst}


# ---------------------------------------------------------------------------
# the per-level detection path (B1-banded / B1-full)


def check_b1_per_level(img: np.ndarray, device):
    """One B1 launch per pyramid level at the level's own width against
    level_maps_plain on the same level, on interior pixels, with check_b1's
    tolerances and no NMS flip allowed. Returns the phase record."""
    dims = orb._level_dims(*img.shape)
    row0, _, _ = detect.level_layout(dims)
    stack = orb.pyramid(torch.from_numpy(img).to(device))
    tol = {"score": (1e-5, 1e-2), "m10": (1e-4, 2.0), "m01": (1e-4, 2.0),
           "blur": (1e-5, 1e-3), "harris": (5e-4, 1.0)}
    flips = n_interior = 0
    max_err = {k: 0.0 for k in tol}
    failures = []
    forms = []
    for lvl, ((h, w), r) in enumerate(zip(dims, row0)):
        level = stack[r: r + h, :w].contiguous()
        got = [m.cpu().numpy() for m in detect.detect_level_cuda(level, FAST_THRESHOLD, orb.BORDER)]
        ref = [m.cpu().numpy() for m in detect.level_maps_plain(level, FAST_THRESHOLD, orb.BORDER)]
        forms.append("full" if h <= detect.FULL_MAX_ROWS else "banded")
        m = np.zeros((h, w), bool)
        m[orb.BORDER: h - orb.BORDER, orb.BORDER: w - orb.BORDER] = True
        n_interior += int(m.sum())
        flips += int((np.isfinite(got[0]) != np.isfinite(ref[0]))[m].sum())
        for i, name in enumerate(tol):
            g, rf = got[i][m], ref[i][m]
            fin = np.isfinite(g) & np.isfinite(rf)
            rtol, atol = tol[name]
            bad = int((np.abs(g[fin] - rf[fin]) > atol + rtol * np.abs(rf[fin])).sum())
            if bad:
                failures.append(f"{name} level {lvl} ({h}x{w}): {bad} pixels off")
            if fin.any():
                max_err[name] = max(max_err[name], float(np.abs(g[fin] - rf[fin]).max()))
    rec = {"size": list(img.shape), "levels": [list(d) for d in dims], "forms": forms,
           "score_flips": flips, "interior_px": n_interior, "max_abs_err": max_err}
    if failures or flips:
        raise AssertionError(f"one-level B1 differs from level_maps_plain: {failures} {rec}")
    return rec


def check_extract_per_level(img: np.ndarray, device, max_features: int):
    """orb.extract(per_level=True) gives the one-launch extract's Features,
    every field equal (the maps agree wherever a feature reads them)."""
    t = torch.from_numpy(img).to(device)
    one = orb.extract(t, max_features, FAST_THRESHOLD)
    per = orb.extract(t, max_features, FAST_THRESHOLD, per_level=True)
    diff = [name for name, a, b in zip(orb.Features._fields, one, per) if not torch.equal(a, b)]
    if diff:
        raise AssertionError(f"extract(per_level=True) differs from extract() in {diff}")
    return int(one.valid.sum())


# Operation counts of B1 per level pixel, from the plain version's separable
# passes (a tap = multiply + add = 2): FAST 16 ring differences both ways and
# their comparisons 64; Sobel x/y 2 x 6 taps 24; the 3 gradient products 3;
# the 7x7 box over 3 products 3 x 14 taps 84; Harris det - k tr^2 6; 3x3 NMS
# 9; moments box + ramp 2 x 62 taps 248; 7x7 Gaussian 14 taps 28.
B1_OPS_PER_PIXEL = 64 + 24 + 3 + 84 + 6 + 9 + 248 + 28
# B2 per edge and pass: transform 15, projection 8, residual and weighted
# chi2 6, Huber 4, the 2x6 Jacobian 36, J^T W J upper triangle 21 x 2 x 2 =
# 84, J^T W r 24; and the passes: 4 rounds x (1 + 10 trial), each round's
# reclassification read from the carried chi2.
B2_OPS_PER_EDGE_PASS = 15 + 8 + 6 + 4 + 36 + 84 + 24
B2_EDGE_PASSES = 4 * 11
# H100 SXM data sheet, at the card's full 700 W limit
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(n_bytes: float, n_ops: float):
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the f32 operations over the peak rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def b1_bound(dims, stacked: bool, n_streams: int = 1):
    """B1's bound over levels `dims`: one stacked launch reads the
    [rows, w0] stack and writes 5 maps of it; one-level launches read and
    write each level at its own size. Operations count real pixels. The
    batched launch does this for each of n_streams stacks."""
    px = n_streams * sum(h * w for h, w in dims)
    _, rows, w0 = detect.level_layout(tuple(dims))
    n_bytes = 4 * 6 * (n_streams * rows * w0 if stacked else px)
    return bound_ms(n_bytes, B1_OPS_PER_PIXEL * px)


def b2_bound(n_slots: int, n_valid: int, n_problems: int = 1):
    """B2's bound for one problem: inputs Xw, uv, info (6 f32 per slot),
    valid (1 byte per slot), T_init and K; outputs T, one inlier byte per
    slot and n_good. Operations count the valid edges' passes. For a batch,
    n_valid is the valid edges of all n_problems together."""
    n_bytes = n_problems * (25 * n_slots + 4 * (16 + 9) + n_slots + 4 * (16 + 1))
    return bound_ms(n_bytes, B2_OPS_PER_EDGE_PASS * B2_EDGE_PASSES * n_valid)


# ---------------------------------------------------------------------------
# the System: two-view initialization, tracking, local mapping with BA


class SystemConfig(NamedTuple):
    h: int
    w: int
    f: float
    max_features: int
    n_warm: int  # frames before the timed window (initialization inside)
    n_timed: int
    step: float  # lateral_trajectory step


# bench.py::_bench_system(fused=False): the repo's system operating point
SYSTEM_FULL = SystemConfig(480, 640, 500.0, 2000, 12, 30, 0.02)
# tests/test_pipeline.py's 28-frame sequence, for the CPU tests
SYSTEM_SMALL = SystemConfig(240, 320, 250.0, 400, 4, 24, 0.07)

# Bounds of the SYSTEM_FULL drive: three times the worst of the same drive
# run with the plain versions on a CPU (tools/torch_profile_system.py
# --device cpu, on the H100 machine's host: scale-aligned keyframe ATE
# 0.004149 over 3 keyframes, live-pose ATE 0.005103 over 38 frames,
# initialized on frame 4, never lost).
MAX_SYSTEM_KF_ATE = 3 * 0.004149
MAX_SYSTEM_FRAME_ATE = 3 * 0.005103

# The fused drives (phases system_fused, system_pipelined, system_fused_kf).
# SYSTEM_KF is bench.py's keyframe-event regime (step 0.06: keyframe events,
# ctx rebuilds and local BA fall inside the timed window).
SYSTEM_KF = SystemConfig(480, 640, 500.0, 2000, 8, 30, 0.06)
# run_steady completes at least 27 of 30 timed frames: the JAX package's
# record of the pipelined regime (BENCH_r05.json, parsed.pipe_stats) shows
# 30 dispatched and 30 hit, a count of events
MIN_STEADY_SHARE = 27 / 30
MAX_FUSED_PAIR_ATE = 0.05  # fused vs unfused, tests/test_fused.py:130
MAX_PIPELINED_PAIR_ATE = 0.03  # pipelined vs fused, tests/test_fused.py:189
# Bounds of the SYSTEM_FULL fused drive: three times the same drive with the
# plain versions on a CPU (tools/torch_profile_system.py --flow fused
# --device cpu, on the H100 machine's host: keyframe ATE 0.004149 over 3
# keyframes, live-pose ATE 0.005035 over 38 frames, initialized on frame 4,
# never lost, run_steady on all 30 timed frames).
MAX_FUSED_KF_ATE = 3 * 0.004149
MAX_FUSED_FRAME_ATE = 3 * 0.005035


def render_system(cfg: SystemConfig):
    """(world, ground-truth poses, images) of the system drive, rendered
    before any timing."""
    world = sim.PlaneWorld(width=cfg.w, height=cfg.h, f=cfg.f, second_plane=(3.0, 0.3))
    poses = sim.lateral_trajectory(cfg.n_warm + cfg.n_timed, step=cfg.step)
    return world, poses, [world.render(T) for T in poses]


# the System's tracking flows: SlamParameters overrides per flow; "fused" is
# the SlamParameters default (fusedTracking=True, fusedOneStep=True) and
# "pipelined" drives it through track_monocular_pipelined
FLOWS = {"unfused": {"fusedTracking": False}, "fused": {}, "pipelined": {}}


# the LoFTR System (tests/test_loftr_pipeline.py::build_loftr_system, the
# reference app's DNN configuration: threshold 0.1, src/main.cpp:63)
LOFTR_THRESHOLD = 0.1
LOFTR_MIN_INI_MATCHES = 60


def build_system(device, cfg: SystemConfig, world, flow: str = "unfused",
                 matcher: str = "orb") -> System:
    """bench.py's System on `device`, in one of FLOWS (default: the
    reference-twin flow, fusedTracking=False), with the ORB matcher or
    (matcher="loftr") test_loftr_pipeline.py's coarse LoFTR configuration."""
    reset_frame_ids()
    reset_map_ids()
    if matcher == "loftr":
        params = SlamParameters(
            fx=world.f, fy=world.f, cx=world.cx, cy=world.cy,
            minIniMatchCount=LOFTR_MIN_INI_MATCHES, initializerModelFallback=True,
            **FLOWS[flow],
        )
        m = LoftrFeatureMatcher(threshold=LOFTR_THRESHOLD, fine=False, device=device)
    else:
        params = SlamParameters(
            fx=world.f, fy=world.f, cx=world.cx, cy=world.cy,
            max_features=cfg.max_features, minIniMatchCount=100,
            initializerModelFallback=True, **FLOWS[flow],
        )
        m = OrbFeatureMatcher(threshold=RATIO, max_features=cfg.max_features, device=device)
    return System(params, m, KeyFrameMatchDatabase(m), verbose=False, device=device)


@contextlib.contextmanager
def drawer_timer(system: System):
    """Time every MapDrawer.update of `system` (the tracker calls it on every
    OK frame, ROADMAP C.10); yields the list of ms, one per call."""
    drawer = system.map_drawer
    real = drawer.update
    ms: list = []

    def update():
        t0 = time.perf_counter()
        real()
        ms.append((time.perf_counter() - t0) * 1e3)

    drawer.update = update
    try:
        yield ms
    finally:
        drawer.update = real


def _pct(xs, q):
    return float(np.percentile(xs, q)) if len(xs) else None


def _reset_launches() -> None:
    detect.detect_maps_cuda.launches = 0
    detect.detect_maps_batch_cuda.launches = 0
    pose_opt_cuda.pose_lm_batched.launches = 0


def _launches() -> dict:
    return {"b1": detect.detect_maps_cuda.launches,
            "b2": pose_opt_cuda.pose_lm_batched.launches}


def _serving_launches() -> dict:
    """_launches() and B1's batched launches (N streams each)."""
    return {**_launches(), "b1_batch": detect.detect_maps_batch_cuda.launches}


PATHS = ("done_steady", "done_two_program", "done_host")


@contextlib.contextmanager
def sync_free_dispatch():
    """Run every fused_host.dispatch_steady_spec under
    torch.cuda.set_sync_debug_mode("error"): a synchronizing op inside it
    raises. Counts the dispatches checked."""
    real = fused_host.dispatch_steady_spec
    checked = {"dispatches": 0}

    def dispatch(tracker, image):
        torch.cuda.set_sync_debug_mode("error")
        try:
            spec = real(tracker, image)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        checked["dispatches"] += spec is not None
        return spec

    with mock.patch.object(fused_host, "dispatch_steady_spec", dispatch):
        yield checked


def run_system(device, cfg: SystemConfig, world, poses, images, system=None,
               flow: str = "unfused") -> dict:
    """Drive the System over every image (gate toggled) in one of FLOWS,
    timing the frames after cfg.n_warm. Each track_monocular call is
    synchronized on a card; the pipelined flow is not (a call completes the
    previous frame and queues the next), its timed window is the wall time
    from the call that completes frame n_warm to the synchronization after
    flush_pipeline. Returns the drive's record: states, live poses, latency,
    stage split, launches, which path completed each frame, the fused flow's
    counters, ATE, and the map drawer's update time over the timed window."""
    system = system or build_system(device, cfg, world, flow)
    system.toggle_initialization_allowed()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda *_: None)
    pipelined = flow == "pipelined"
    step = system.track_monocular_pipelined if pipelined else system.track_monocular
    stats = fused_host.pipe_stats(system.tracker)
    _reset_launches()
    states, Tcw, frame_ms, kf_event_ms, frame_launches, frame_path = [], [], [], [], [], []
    n_kf_before = 0
    t_timed = t_window = 0.0
    stats0: dict = {}
    n = len(images)
    n_draw0 = 0
    with drawer_timer(system) as drawer_ms:
        for call in range(n + pipelined):
            done = call - pipelined  # the frame this call completes (-1: none)
            if done == cfg.n_warm:
                system.timer.reset()
                n_kf_before = system.map.n_keyframes()
                stats0 = dict(stats)
                n_draw0 = len(drawer_ms)
                t_window = time.perf_counter()
            before = (_launches(), {k: stats.get(k, 0) for k in PATHS})
            t0 = time.perf_counter()
            if call < n:
                step(images[call], timestamp=call * 0.1)
            else:
                system.flush_pipeline()
            if not pipelined:
                sync(device)
            ms = (time.perf_counter() - t0) * 1e3
            if done < 0:
                continue
            states.append(system.tracker.state.name)
            T = system.tracker.current_frame.get_pose()
            Tcw.append(np.full((4, 4), np.nan, np.float32) if T is None else T)
            frame_launches.append({k: v - before[0][k] for k, v in _launches().items()})
            frame_path.append(next((k for k in PATHS if stats.get(k, 0) > before[1][k]), None))
            if done >= cfg.n_warm:
                t_timed += ms
                frame_ms.append(ms)
                n_kf = system.map.n_keyframes()
                if n_kf != n_kf_before:
                    kf_event_ms.append(ms)
                    n_kf_before = n_kf
        sync(device)
        if pipelined:
            t_timed = (time.perf_counter() - t_window) * 1e3
    launches = _launches()

    gt_t = np.arange(len(images)) * 0.1
    gt_p = np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in poses])
    kfs = sorted((kf for kf in system.map.all_keyframes() if not kf.is_bad),
                 key=lambda kf: kf.id)
    ate_kf, n_kf_assoc = trajectory.ate_rmse(
        np.array([kf.timestamp for kf in kfs]),
        np.stack([kf.get_camera_center() for kf in kfs]) if kfs else np.zeros((0, 3)),
        gt_t, gt_p,
    )
    Tcw = np.stack(Tcw)
    posed = ~np.isnan(Tcw[:, 0, 0])
    centres = -np.einsum("nji,nj->ni", Tcw[:, :3, :3], Tcw[:, :3, 3])
    ate_frames, _ = trajectory.ate_rmse(gt_t[posed], centres[posed], gt_t, gt_p)
    first_ok = states.index("OK") if "OK" in states else None
    n_timed = len(frame_ms)
    timed_paths = frame_path[cfg.n_warm:]
    fused_stats = {k: v for k, v in stats.items() if not k.endswith("_samples_ms")}
    timed_stats = {k: v - stats0.get(k, 0) for k, v in fused_stats.items()}
    for k in ("process", "dispatch"):
        samples = stats.get(f"{k}_samples_ms", [])[cfg.n_warm + 1:]
        if samples:
            fused_stats[f"{k}_p50_ms"] = _pct(samples, 50)
    return {
        "flow": flow,
        "frames": len(images), "size": [cfg.h, cfg.w], "max_features": cfg.max_features,
        "states": states, "Tcw": Tcw,
        "first_ok_frame": first_ok,
        "not_ok_after_first_ok": None if first_ok is None else sum(
            s != "OK" for s in states[first_ok:]),
        "lost_frames": states.count("LOST"),
        "keyframes": system.map.n_keyframes(), "map_points": system.map.n_map_points(),
        "ate_kf": ate_kf, "ate_kf_assoc": n_kf_assoc, "ate_frames": ate_frames,
        "timed_frames": n_timed,
        "fps": n_timed / (t_timed / 1e3) if n_timed else None,
        "frame_p50_ms": _pct(frame_ms, 50), "frame_p95_ms": _pct(frame_ms, 95),
        "kf_events": len(kf_event_ms), "kf_event_p50_ms": _pct(kf_event_ms, 50),
        "kf_event_p95_ms": _pct(kf_event_ms, 95),
        "stage_ms_per_frame": {k: 1e3 * v / max(n_timed, 1)
                               for k, v in system.timer.totals.items()},
        "launches": launches,
        "timed_paths": {"run_steady": timed_paths.count("done_steady"),
                        "run": timed_paths.count("done_two_program"),
                        "host": n_timed - timed_paths.count("done_steady")
                        - timed_paths.count("done_two_program")},
        "fused_stats": fused_stats, "timed_stats": timed_stats,
        "drawer_updates_timed": len(drawer_ms) - n_draw0,
        "drawer_update_ms_per_timed_frame": sum(drawer_ms[n_draw0:]) / max(n_timed, 1),
        "drawer_update_ms_p50": _pct(drawer_ms[n_draw0:], 50),
        "frame_launches": frame_launches, "frame_path": frame_path,
        "system": system,
    }


def check_system_run(run: dict, kernels: bool) -> None:
    """The system drive's bounds: it initializes, never loses track (so
    never reaches relocalization), keeps both ATEs within MAX_SYSTEM_*_ATE,
    and, for the drive through the kernels, launches B1 once per new frame
    and B2 at least once per tracked frame."""
    if run["first_ok_frame"] is None:
        raise AssertionError("the System never initialized")
    if run["lost_frames"] or run["not_ok_after_first_ok"]:
        raise AssertionError(f"tracking was lost: {run['states']}")
    n_tracked = run["frames"] - run["first_ok_frame"] - 1
    if kernels:
        if run["launches"]["b1"] != run["frames"] or run["launches"]["b2"] < n_tracked:
            raise AssertionError(f"launches {run['launches']} over {run['frames']} frames, "
                                 f"{n_tracked} tracked")
    if not (run["ate_kf"] <= MAX_SYSTEM_KF_ATE and run["ate_frames"] <= MAX_SYSTEM_FRAME_ATE):
        raise AssertionError(f"ATE keyframes {run['ate_kf']}, frames {run['ate_frames']}")


def system_record(run: dict) -> dict:
    """run_system's record without the objects and per-frame lists, for
    printing."""
    return {k: v for k, v in run.items()
            if k not in ("Tcw", "system", "states", "frame_launches", "frame_path")}


def trajectory_pair(a: System, b: System) -> tuple:
    """(ATE of a's per-frame trajectory against b's, frames associated):
    trajectory.ate_rmse of both save_trajectory_tum exports
    (tests/test_fused.py:117-130)."""
    with tempfile.TemporaryDirectory() as d:
        pa, pb = f"{d}/a.txt", f"{d}/b.txt"
        a.save_trajectory_tum(pa)
        b.save_trajectory_tum(pb)
        return trajectory.ate_rmse(*trajectory.read_tum(pa)[:2], *trajectory.read_tum(pb)[:2])


def check_fused_run(run: dict, kernels: bool) -> None:
    """The fused drive's bounds: it initializes and is never lost,
    run_steady completes at least MIN_STEADY_SHARE of the timed frames, both
    ATEs stay within MAX_FUSED_*_ATE, and, through the kernels, every frame
    run_steady completed launched B1 once and B2 twice."""
    if run["first_ok_frame"] is None:
        raise AssertionError("the System never initialized")
    if run["lost_frames"] or run["not_ok_after_first_ok"]:
        raise AssertionError(f"tracking was lost: {run['states']}")
    if run["timed_paths"]["run_steady"] < MIN_STEADY_SHARE * run["timed_frames"]:
        raise AssertionError(f"run_steady completed {run['timed_paths']} of "
                             f"{run['timed_frames']} timed frames; {run['fused_stats']}")
    if kernels:
        bad = [i for i, (p, n) in enumerate(zip(run["frame_path"], run["frame_launches"]))
               if p == "done_steady" and n != {"b1": 1, "b2": 2}]
        if bad:
            raise AssertionError(f"run_steady frames {bad} launched "
                                 f"{[run['frame_launches'][i] for i in bad]}")
    if not (run["ate_kf"] <= MAX_FUSED_KF_ATE and run["ate_frames"] <= MAX_FUSED_FRAME_ATE):
        raise AssertionError(f"ATE keyframes {run['ate_kf']}, frames {run['ate_frames']}")


# ---------------------------------------------------------------------------
# relocalization and loop correction


class LoopConfig(NamedTuple):
    max_features: int
    step: float  # rect_loop_trajectory step
    drop_at: int  # two flat frames are fed after this frame of the drive
    n_flat: int


# The JAX package's quality drive (quality_bench.run_quality(force_cpu=False):
# the hard world at 320x240, f = 250, 2000 features, the rect loop at pace
# 0.075, 141 poses) with test_hard_world.py's dropout leg (two flat frames
# after frame 10)
LOOP_FULL = LoopConfig(2000, 0.075, 10, 2)
MIN_OK_SHARE = 0.8  # test_hard_world.py:137
MAX_LOST_DELAY = 3  # frames from the dropout to LOST
MAX_ORTHO_ERR = 1e-4  # |R R^T - I| of every keyframe (test_reloc_loop.py:198)


def render_loop(cfg: LoopConfig):
    """(world, ground-truth poses, images) of the quality drive."""
    world = sim.PlaneWorld(plane_z=2.0, second_plane=sim.RECT_LOOP_PLANES, texture="smooth")
    poses = sim.rect_loop_trajectory(3.0, 2.2, cfg.step)
    return world, poses, [world.render(T) for T in poses]


def frame_ate(system: System, gt_t, gt_p):
    """Scale-aligned ATE of the System's per-frame trajectory export against
    ground truth, None under 10 associated frames (quality_bench's ate_now)."""
    with tempfile.TemporaryDirectory() as d:
        system.save_trajectory_tum(f"{d}/fr.txt")
        t_fr, p_fr, _ = trajectory.read_tum(f"{d}/fr.txt")
    if len(t_fr) < 3:
        return None
    a, n = trajectory.ate_rmse(t_fr, p_fr, np.asarray(gt_t), np.stack(gt_p))
    return float(a) if n >= 10 else None


def pose_ortho_errors(system: System):
    """(all keyframe poses finite, the largest |R R^T - I| over them)."""
    kfs = [kf for kf in system.map.all_keyframes() if not kf.is_bad]
    T = np.stack([kf.get_pose() for kf in kfs]).astype(np.float64)
    R = T[:, :3, :3]
    err = np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max()
    return bool(np.isfinite(T).all()), float(err)


@contextlib.contextmanager
def loop_spies(system: System, sync):
    """Record every relocalization attempt (frame, candidates, EPnP
    correspondences, hypotheses and inliers, the pose LM's n_good, success,
    ms, B2 launches) and the loop correction's steps (essential graph, loop
    GBA, propagation: ms each), without changing what they compute."""
    from mono_slam_framework_torch.estimation import epnp
    from mono_slam_framework_torch.slam import loop_closing, tracking

    tr, lc = system.tracker, system.loop_closer
    log = {"reloc": [], "graph_ms": [], "gba_ms": [], "gba_total_ms": []}
    real = {"reloc": tr.relocalization, "cands": system.kf_db.detect_relocalization_candidates,
            "pnp": epnp.solve_pnp_ransac, "lm": tracking.optimize_frame_pose,
            "graph": loop_closing.optimize_pose_graph_np, "gba": loop_closing.run_global_ba,
            "gba_total": lc.run_global_bundle_adjustment}
    attempt: dict = {}

    def cands(frame):
        out = real["cands"](frame)
        attempt["candidates"] = len(out)
        return out

    def pnp(X, uv, K, generator, **kw):
        n_min, hyp = epnp.ransac_iterations(len(X), kw["probability"], kw["min_inliers"],
                                            kw["max_iterations"])
        ok, T, inl = real["pnp"](X, uv, K, generator, **kw)
        attempt.setdefault("epnp", []).append({
            "correspondences": len(X), "hypotheses": hyp, "min_inliers": n_min,
            "inliers": int(np.sum(inl)), "ok": ok})
        return ok, T, inl

    def lm(frame, device):
        n = real["lm"](frame, device)
        attempt.setdefault("n_good", []).append(n)
        return n

    def reloc():
        attempt.clear()
        b2 = pose_opt_cuda.pose_lm_batched.launches
        t0 = time.perf_counter()
        with mock.patch.object(tracking, "optimize_frame_pose", lm), \
                mock.patch.object(tracking.epnp, "solve_pnp_ransac", pnp):
            ok = real["reloc"]()
        sync()
        log["reloc"].append({"frame": tr.current_frame.id, **attempt, "success": ok,
                             "ms": (time.perf_counter() - t0) * 1e3,
                             "b2_launches": pose_opt_cuda.pose_lm_batched.launches - b2})
        return ok

    def timed(key, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            log[f"{key}_ms"].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    tr.relocalization = reloc
    system.kf_db.detect_relocalization_candidates = cands
    lc.run_global_bundle_adjustment = timed("gba_total", real["gba_total"])
    try:
        with mock.patch.object(loop_closing, "optimize_pose_graph_np", timed("graph", real["graph"])), \
                mock.patch.object(loop_closing, "run_global_ba", timed("gba", real["gba"])):
            yield log
    finally:
        tr.relocalization = real["reloc"]
        system.kf_db.detect_relocalization_candidates = real["cands"]
        lc.run_global_bundle_adjustment = real["gba_total"]


def run_loop_drive(device, cfg: LoopConfig, world, poses, images) -> dict:
    """The quality drive through System.track_monocular in the default fused
    flow: set_minimum_keyframes(0), the initialization gate re-pressed
    whenever the state is NO_IMAGES_YET, cfg.n_flat flat frames after frame
    cfg.drop_at, correct_loop spied for the ATE just before and after it
    (quality_bench.py:164-181). Returns the drive's record and the System."""
    reset_frame_ids()
    reset_map_ids()
    params = SlamParameters(fx=world.f, fy=world.f, cx=world.cx, cy=world.cy,
                            max_features=cfg.max_features, minIniMatchCount=70,
                            initializerModelFallback=True)
    matcher = OrbFeatureMatcher(threshold=RATIO, max_features=cfg.max_features, device=device)
    system = System(params, matcher, KeyFrameMatchDatabase(matcher), verbose=False,
                    device=device)
    system.toggle_initialization_allowed()
    system.set_minimum_keyframes(0)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda *_: None)
    stats = fused_host.pipe_stats(system.tracker)
    lc = system.loop_closer
    gt_t, gt_p = [], []
    loops = []
    frame_no = [0]
    real_correct = lc.correct_loop

    def spy_correct():
        before = frame_ate(system, gt_t, gt_p)
        ctx0 = stats.get("ctx_builds", 0)
        t0 = time.perf_counter()
        real_correct()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        loops.append({"frame": frame_no[0], "kf": lc.current_kf.id,
                      "matched_kf": lc.matched_kf.id, "fused": lc.last_fuse_count,
                      "prealign": lc.last_prealign, "ms": ms,
                      "ate_before": before, "ate_after": frame_ate(system, gt_t, gt_p),
                      "ctx_builds_at_loop": ctx0})

    lc.correct_loop = spy_correct
    _reset_launches()
    states, frame_ms, kf_event_ms = [], [], []
    dropout_index = None
    t = 0.0
    t_drive = time.perf_counter()
    with loop_spies(system, sync) as log, drawer_timer(system) as drawer_ms:
        feed = []
        for i, T in enumerate(poses):
            feed.append((i, images[i], T))
            if i == cfg.drop_at:
                feed += [(i, None, None)] * cfg.n_flat
        for i, img, T in feed:
            frame_no[0] = i
            n_kf = system.map.n_keyframes()
            t0 = time.perf_counter()
            if img is None:
                dropout_index = len(states) if dropout_index is None else dropout_index
                system.track_monocular(np.full((world.h, world.w), 128.0, np.float32), t)
            else:
                system.track_monocular(img, t)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            frame_ms.append(ms)
            if system.map.n_keyframes() != n_kf:
                kf_event_ms.append(ms)
            if img is not None:
                gt_t.append(t)
                gt_p.append(-(T[:3, :3].T @ T[:3, 3]))
            states.append(system.tracker.state.name)
            t += 0.1
            if system.tracker.state.name == "NO_IMAGES_YET":
                system.toggle_initialization_allowed()
    wall_s = time.perf_counter() - t_drive
    lc.correct_loop = real_correct
    lost = [k for k, s in enumerate(states) if s == "LOST"]
    finite, ortho = pose_ortho_errors(system)
    return {
        "frames": len(states), "poses": len(poses), "size": [world.h, world.w],
        "max_features": cfg.max_features,
        "states": states, "state_counts": {s: states.count(s) for s in set(states)},
        "dropout_index": dropout_index, "first_lost_index": lost[0] if lost else None,
        "ok_share": sum(s == "OK" for s in states) / len(states),
        "final_state": states[-1],
        "reloc_attempts": log["reloc"],
        "last_reloc_frame_id": system.tracker.last_reloc_frame_id,
        "loop_detected": lc.last_loop_kf_id > 0, "loops": loops,
        "graph_ms": log["graph_ms"], "gba_ms": log["gba_ms"],
        "propagation_ms": [a - b for a, b in zip(log["gba_total_ms"], log["gba_ms"])],
        "final_ate": frame_ate(system, gt_t, gt_p),
        "keyframes": system.map.n_keyframes(), "map_points": system.map.n_map_points(),
        "poses_finite": finite, "max_ortho_err": ortho,
        "launches": _launches(),
        "fps": len(states) / wall_s, "wall_s": wall_s,
        "frame_p50_ms": _pct(frame_ms, 50), "frame_p95_ms": _pct(frame_ms, 95),
        "kf_events": len(kf_event_ms), "kf_event_p95_ms": _pct(kf_event_ms, 95),
        "fused_stats": {k: v for k, v in stats.items() if not k.endswith("_samples_ms")},
        "drawer_updates": len(drawer_ms),
        "drawer_update_ms_per_frame": sum(drawer_ms) / len(states),
        "drawer_update_ms_p50": _pct(drawer_ms, 50),
        "drawer_update_ms_last": drawer_ms[-1] if drawer_ms else None,
        "system": system,
    }


def check_loop_drive(run: dict, kernels: bool) -> None:
    """The quality drive's bounds: LOST within MAX_LOST_DELAY frames of the
    dropout; a relocalization succeeds (and launched B2 on a card); the OK
    share is at least MIN_OK_SHARE and the drive ends OK; every keyframe pose
    is finite and orthonormal to MAX_ORTHO_ERR. Whether the genuine loop is
    detected is recorded, not required: in this world it turns on float
    noise (PERF.md §6: the port's drive is deterministic and relocalizes onto
    the first keyframes at the revisit). A loop that is detected must have
    its first correction lower the ATE, and the fused ctx must be rebuilt
    after it. The correction itself is held on the surgical loop
    (run_surgical_loop)."""
    d, lost = run["dropout_index"], run["first_lost_index"]
    if lost is None or not d <= lost <= d + MAX_LOST_DELAY:
        raise AssertionError(f"LOST at {lost}, dropout at {d}: {run['states'][:d + 8]}")
    good = [a for a in run["reloc_attempts"] if a["success"]]
    if run["last_reloc_frame_id"] <= 0 or not good:
        raise AssertionError(f"no relocalization succeeded: {run['reloc_attempts']}")
    if kernels and good[0]["b2_launches"] < 1:
        raise AssertionError(f"the relocalization launched no B2: {good[0]}")
    if run["ok_share"] < MIN_OK_SHARE or run["final_state"] != "OK":
        raise AssertionError(f"OK share {run['ok_share']}, final {run['final_state']}")
    if not run["poses_finite"] or run["max_ortho_err"] >= MAX_ORTHO_ERR:
        raise AssertionError(f"keyframe poses: finite {run['poses_finite']}, "
                             f"|R R^T - I| {run['max_ortho_err']}")
    if run["loops"]:
        # the first correction closes the loop; a later one re-detects the
        # same place once the cooldown has passed
        loop = run["loops"][0]
        if not (loop["ate_before"] is not None and loop["ate_after"] is not None
                and loop["ate_after"] < loop["ate_before"]):
            raise AssertionError(f"the loop correction did not lower the ATE: {loop}")
        if run["fused_stats"].get("ctx_builds", 0) <= loop["ctx_builds_at_loop"]:
            raise AssertionError(f"no fused ctx rebuilt after the loop: {run['fused_stats']}")


# test_reloc_loop.py:107-201's deterministic loop: a revisit keyframe built
# at the first keyframe's viewpoint with its own duplicate map points
SURGICAL_FRAMES = 16
# the world shift of the revisit's duplicates when pre-alignment is on (a
# drifted revisit, so that the Sim(3) fit and the essential graph have a
# correction to find)
SURGICAL_DRIFT = (0.04, -0.03, 0.02)


def surgical_loop_setup(device, max_features: int, prealign: bool, drift=None) -> dict:
    """Drive test_reloc_loop.py's 16-frame lateral sequence, then build the
    revisit keyframe at keyframe 0's viewpoint with a duplicate map point for
    every match to one of keyframe 0's points; with `drift` (a world
    translation) the duplicates and the revisit pose are shifted by it."""
    world = sim.PlaneWorld(second_plane=(3.0, 0.3))
    poses = sim.lateral_trajectory(SURGICAL_FRAMES, step=0.07)
    reset_frame_ids()
    reset_map_ids()
    params = SlamParameters(fx=world.f, fy=world.f, cx=world.cx, cy=world.cy,
                            max_features=max_features, minIniMatchCount=100,
                            initializerModelFallback=True, loopPrealignSim3=prealign)
    matcher = OrbFeatureMatcher(threshold=RATIO, max_features=max_features, device=device)
    system = System(params, matcher, KeyFrameMatchDatabase(matcher), verbose=False,
                    device=device)
    system.toggle_initialization_allowed()
    states = []
    for i, T in enumerate(poses):
        system.track_monocular(world.render(T), timestamp=i * 0.1)
        states.append(system.tracker.state.name)
    tracker = system.tracker
    kfs = sorted(system.map.all_keyframes(), key=lambda k: k.id)
    kf_old = kfs[0]
    shift = np.zeros(3, np.float32) if drift is None else np.asarray(drift, np.float32)
    frame = tracker.frame_factory.create(kf_old.image, 99.0, tracker.K)
    T = kf_old.get_pose()
    T[:3, 3] -= T[:3, :3] @ shift  # the camera that sees X + shift where kf_old sees X
    frame.set_pose(T)
    kf_new = tracker.keyframe_factory.create(frame, system.map, system.kf_db)
    system.map.add_keyframe(kf_new)
    res = system.matcher.match_frames(kf_new, kf_old)
    n_assoc = 0
    for i in range(res.num_matches):
        mp_old = res.get_map_point2(i)
        if mp_old is None:
            continue
        dup = MapPoint(mp_old.world_pos + shift, kf_new, system.map)
        kp1 = tuple(res.keypoints1[i])
        kf_new.keypoint_map.set_map_point(kp1, dup, measurement=tuple(res.kp1_f[i]))
        dup.add_observation(kf_new, kp1, measurement=tuple(res.kp1_f[i]))
        system.map.add_map_point(dup)
        n_assoc += 1
    return {"system": system, "states": states, "kfs": kfs, "kf_old": kf_old,
            "kf_new": kf_new, "n_matches": res.num_matches, "n_assoc": n_assoc}


def run_surgical_loop(setup: dict, sync=lambda: None) -> dict:
    """Hand the revisit keyframe to loop closing and run one step; checks
    test_reloc_loop.py:162-201's invariants (the staged-GBA snapshots to
    1e-6 only without pre-alignment, which moves poses before the GBA; with
    it, that the Sim(3) fit and the essential graph ran and that the
    drifted revisit keyframe moved toward its true place) and that the fused
    ctx is rebuilt after the correction. Returns the record."""
    system, kfs, kf_new = setup["system"], setup["kfs"], setup["kf_new"]
    lc = system.loop_closer
    if setup["n_assoc"] <= system.params.minNumMPMatches:
        raise AssertionError(f"{setup['n_assoc']} duplicates, need more than "
                             f"{system.params.minNumMPMatches}")
    if kf_new.id < system.params.loopDetectionMaxFrames or \
            setup["kf_old"] in kf_new.get_connected_keyframes():
        raise AssertionError("the revisit keyframe is inside the cooldown or covisible")
    poses_before = {kf.id: kf.get_pose().copy() for kf in kfs}
    changes_before = system.map.get_last_big_change_idx()
    stats = fused_host.pipe_stats(system.tracker)
    ctx = fused_host._ensure_ctx(system.tracker, system.matcher)
    builds = stats["ctx_builds"]
    # the revisit sits at keyframe 0's viewpoint: its camera centre's error
    centre_err = lambda: float(np.linalg.norm(  # noqa: E731
        kf_new.get_camera_center() - setup["kf_old"].get_camera_center()))
    err_before = centre_err()
    t0 = time.perf_counter()
    lc.insert_keyframe(kf_new)
    lc.run()
    sync()
    rec = {"prealign": lc.prealign, "ms": (time.perf_counter() - t0) * 1e3,
           "keyframes": len(kfs) + 1, "duplicates": setup["n_assoc"],
           "loop_kf": lc.last_loop_kf_id, "matched_kf": getattr(lc.matched_kf, "id", None),
           "fused": lc.last_fuse_count, "prealign_fit": lc.last_prealign,
           "revisit_centre_err_before": err_before, "revisit_centre_err_after": centre_err()}
    rebuilt = fused_host._ensure_ctx(system.tracker, system.matcher) is not ctx
    rec["ctx_rebuilt"] = rebuilt and stats["ctx_builds"] == builds + 1
    if not rec["ctx_rebuilt"]:
        raise AssertionError(f"the fused ctx was not rebuilt after the correction: {rec}")
    if lc.last_loop_kf_id != kf_new.id or lc.matched_kf not in kfs:
        raise AssertionError(f"the loop did not fire on the revisit keyframe: {rec}")
    alive = [kf for kf in system.map.all_keyframes() if not kf.is_bad]
    if lc.prealign:
        fit = lc.last_prealign
        if not fit or "nodes" not in fit:
            raise AssertionError(f"the Sim(3) fit and essential graph did not run: {rec}")
        if not rec["revisit_centre_err_after"] < rec["revisit_centre_err_before"]:
            raise AssertionError(f"the correction did not move the revisit toward its place: {rec}")
    else:
        err = max(float(np.abs(kf.Tcw_bef_gba - poses_before[kf.id]).max())
                  for kf in kfs if not kf.is_bad)
        rec["max_bef_gba_err"] = err
        if err > 1e-6:
            raise AssertionError(f"Tcw_bef_gba differs from the pre-loop pose by {err}")
    unstamped = [kf.id for kf in alive if kf.ba_global_for_kf != kf_new.id]
    if unstamped:
        raise AssertionError(f"keyframes {unstamped} missed the loop GBA propagation")
    finite, ortho = pose_ortho_errors(system)
    rec.update(poses_finite=finite, max_ortho_err=ortho)
    if not finite or ortho >= MAX_ORTHO_ERR:
        raise AssertionError(f"poses after the loop: {rec}")
    if not (system.map.get_last_big_change_idx() > changes_before and system.map_changed()):
        raise AssertionError("the loop correction flagged no big change")
    return rec


# ---------------------------------------------------------------------------
# checkpoints, and the System under torch.profiler


def checkpoint_round_trip(device, cfg: SystemConfig, world, system: System) -> dict:
    """tests/test_pipeline.py:108-122's round trip on `system`'s map: save it,
    load it into a fresh System on the same device; the keyframe count must
    be equal, at least 0.8 of the map points must survive the reload's
    bad-flag cascade, and the first keyframe's Tcw must be within 1e-6."""
    n_kf, n_mp = system.map.n_keyframes(), system.map.n_map_points()
    first = sorted(system.map.all_keyframes(), key=lambda k: k.id)[0].Tcw.copy()
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/map.npz"
        t0 = time.perf_counter()
        system.save_checkpoint(path)
        t1 = time.perf_counter()
        size = pathlib.Path(path).stat().st_size
        other = build_system(device, cfg, world, "fused")
        t2 = time.perf_counter()
        other.load_checkpoint(path)
        t3 = time.perf_counter()
    kf_l = sorted(other.map.all_keyframes(), key=lambda k: k.id)[0]
    rec = {"keyframes": n_kf, "map_points": n_mp,
           "loaded_keyframes": other.map.n_keyframes(),
           "loaded_map_points": other.map.n_map_points(),
           "first_kf_Tcw_max_abs_diff": float(np.abs(kf_l.Tcw - first).max()),
           "bytes": size, "save_ms": (t1 - t0) * 1e3, "load_ms": (t3 - t2) * 1e3}
    if not (rec["loaded_keyframes"] == n_kf and rec["loaded_map_points"] >= 0.8 * n_mp
            and rec["first_kf_Tcw_max_abs_diff"] <= 1e-6 and kf_l.keypoint_map.size > 0):
        raise AssertionError(f"checkpoint round trip: {rec}")
    return rec


# host-side CUDA runtime calls that wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def profile_tail(dev, cfg: SystemConfig, world, poses, images, flow: str, k: int,
                 matcher: str = "orb") -> tuple:
    """Drive all but the last k frames with run_system, then the last k
    calls under torch.profiler. Returns (run_system's record of the head,
    the per-frame device figures of the profiled calls: device-busy ms, the
    idle share, device ops, device->host copies, synchronizations (the
    closing synchronize left out) and the top device kernels; the launch
    counts of head and tail together under "launches_total")."""
    from torch.profiler import ProfilerActivity, profile

    n = len(images) - k
    system = build_system(dev, cfg, world, flow, matcher)
    head = run_system(dev, cfg._replace(n_timed=n - cfg.n_warm), world,
                      poses[:n], images[:n], system=system, flow=flow)
    pipelined = flow == "pipelined"
    step = system.track_monocular_pipelined if pipelined else system.track_monocular
    stats = fused_host.pipe_stats(system.tracker)
    if pipelined:  # run_system flushed: start the pipeline again on frame n
        step(images[n], timestamp=n * 0.1)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    paths = []
    with profile(activities=activities) as prof:
        t1 = time.perf_counter()
        for i in range(n + pipelined, len(images) + pipelined):
            before = {p: stats.get(p, 0) for p in PATHS}
            if i < len(images):
                step(images[i], timestamp=i * 0.1)
            else:
                system.flush_pipeline()
            paths.append(next((p for p in PATHS if stats.get(p, 0) > before[p]), None))
        sync()
        wall = time.perf_counter() - t1
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:15]
    d2h = [e.name for e in kernels if "DtoH" in e.name]
    syncs = [e.name for e in events if e.name in SYNC_CALLS]
    if "cudaDeviceSynchronize" in syncs:
        syncs.remove("cudaDeviceSynchronize")  # the closing synchronize
    head["launches_total"] = _launches()
    return head, {
        "frames": k, "paths": paths, "final_state": system.tracker.state.name,
        "wall_ms_per_frame": 1e3 * wall / k,
        "device_busy_ms_per_frame": busy_us / 1e3 / k,
        "idle_share": 1.0 - (busy_us / 1e6) / wall,
        "device_ops_per_frame": len(kernels) / k,
        "dtoh_copies_per_frame": len(d2h) / k,
        "synchronizations_per_frame": len(syncs) / k,
        "by_name_per_frame": {n: c / k for n, c in collections.Counter(d2h + syncs).items()},
        "top": [{"name": name[:90], "ms_per_frame": sum(v) / 1e3 / k,
                 "calls_per_frame": len(v) / k} for name, v in top],
    }


# ---------------------------------------------------------------------------
# the LoFTR matcher

# PERF.md §2's System regime with the LoFTR matcher: 640x480, step 0.02,
# 12 warm + 30 timed frames (max_features is not used by LoFTR)
SYSTEM_LOFTR = SystemConfig(480, 640, 500.0, 2000, 12, 30, 0.02)
PROFILE_FRAMES = 5  # calls after each LoFTR drive's timed window, profiled
# tests/test_loftr_pipeline.py's bounds: frame ATE against ground truth
# (:95-97, :147-152) and the fused-vs-unfused trajectory pair (:118-121),
# also held for the pipelined-vs-fused pair
MAX_LOFTR_ATE = 0.2
MAX_LOFTR_PAIR_ATE = 0.06
# The card's bf16 LoFTR against its f32 one on the rendered pair: of the
# cells whose f32 best match is above the threshold, the share whose argmax
# stays the same; and the batched database match against serial calls
# (Jaccard index of the above-threshold match sets; on the CPU both are
# equal exactly, tests/test_torch_loftr_matcher.py)
MIN_LOFTR_BF16_ARGMAX = 0.9
MIN_LOFTR_MANY_JACCARD = 0.95
LOFTR_B2_SLOTS = 1200  # one edge slot per /16 cell at 480x640
QUALITY_LOFTR_POSES = 40  # quality_bench.run_quality_loftr's default


class _Frame:
    """A stand-in frame for the matcher: an image under a cache key."""

    def __init__(self, key, image):
        self.id, self.image, self.matcher_key = key, image, ("chip_smoke", key)


def loftr_pair():
    """tests/test_loftr.py's rendered 640x480 pair."""
    world = sim.PlaneWorld(width=640, height=480, f=500.0, second_plane=(3.0, 0.3))
    poses = sim.lateral_trajectory(4, step=0.2)
    return world.render(poses[0]), world.render(poses[2])


@contextlib.contextmanager
def loftr_f32():
    """The LoFTR model's learned-weight products in f32 on the card as well
    (the CPU's precision), for comparison with the card's bf16 path."""
    with mock.patch.object(loftr_native, "_lowp", lambda t: t):
        yield


def _match_set(res) -> set:
    return set(map(tuple, np.concatenate([res.keypoints1, res.keypoints2], 1).tolist()))


def _jaccard(a: set, b: set) -> float:
    return len(a & b) / max(len(a | b), 1)


def check_loftr_model(dev) -> dict:
    """Phase loftr_model (see the module docstring)."""
    a, b = loftr_pair()
    thr = LOFTR_THRESHOLD
    m = LoftrFeatureMatcher(threshold=thr, device=dev)
    model = m.model
    x = torch.from_numpy(np.stack([a, b])[:, None] / 255.0).float()
    conf_cpu = loftr_native.loftr_confidence(loftr_native.load_model(device="cpu"),
                                             x[:1], x[1:])[0].numpy()
    xd = x.to(dev)
    conf16 = loftr_native.loftr_confidence(model, xd[:1], xd[1:])[0].cpu().numpy()
    with loftr_f32():
        conf32 = loftr_native.loftr_confidence(model, xd[:1], xd[1:])[0].cpu().numpy()
    strong = conf32.max(1) > thr
    rec = {
        "phase": "loftr_model", "size": [480, 640], "cells": conf32.shape[0],
        "f32_vs_cpu_max_abs": float(np.abs(conf32 - conf_cpu).max()),
        "f32_vs_cpu_argmax_agreement": float((conf32.argmax(1) == conf_cpu.argmax(1)).mean()),
        "bf16_vs_f32_max_abs": float(np.abs(conf16 - conf32).max()),
        "bf16_vs_f32_argmax_agreement": float((conf16.argmax(1) == conf32.argmax(1)).mean()),
        "bf16_vs_f32_argmax_agreement_strong": float(
            (conf16.argmax(1) == conf32.argmax(1))[strong].mean()),
        "strong_cells": int(strong.sum()),
        "above_threshold_f32": int((conf32 > thr).sum()),
        "above_threshold_bf16": int((conf16 > thr).sum()),
        "above_threshold_both": int(((conf32 > thr) & (conf16 > thr)).sum()),
    }
    # the matcher's sets: the batched database match against serial calls,
    # and the bf16 pair against the f32 one
    frames = [_Frame(0, a), _Frame(1, b), _Frame(2, a)]
    query = _Frame(9, b)
    batched = [_match_set(r) for r in m.match_against_many(query, frames)]
    serial = [_match_set(m.match_frames(query, f)) for f in frames]
    rec["many_vs_serial_matches"] = [[len(p), len(q)] for p, q in zip(batched, serial)]
    rec["many_vs_serial_jaccard"] = [_jaccard(p, q) for p, q in zip(batched, serial)]
    pair16 = _match_set(m.match_frames(frames[0], frames[1]))
    with loftr_f32():
        m32 = LoftrFeatureMatcher(threshold=thr, device=dev)
        pair32 = _match_set(m32.match_frames(frames[0], frames[1]))
    rec["match_frames_bf16"], rec["match_frames_f32"] = len(pair16), len(pair32)
    rec["match_frames_common"] = len(pair16 & pair32)
    # fine_refine on the f32 pair's cells, bf16 against f32 (model pixels)
    f32_cells = np.array([[(x1 // 16) + 40 * (y1 // 16), (x2 // 16) + 40 * (y2 // 16)]
                          for x1, y1, x2, y2 in sorted(pair32)], np.int64).reshape(-1, 2)
    cells = torch.from_numpy(f32_cells).to(dev)
    fine16 = loftr_native.encode_with_fine(model, xd)[1]
    off16 = loftr_native.fine_refine(fine16[0], fine16[1], cells[:, 0], cells[:, 1])
    with loftr_f32():
        fine32 = loftr_native.encode_with_fine(model, xd)[1]
        off32 = loftr_native.fine_refine(fine32[0], fine32[1], cells[:, 0], cells[:, 1])
    off16, off32 = off16.cpu().numpy(), off32.cpu().numpy()
    rec["fine_matches"] = len(f32_cells)
    rec["fine_offsets_bf16_vs_f32_max_abs_px"] = float(np.abs(off16 - off32).max())
    rec["fine_offsets_bf16_vs_f32_median_abs_px"] = float(np.median(np.abs(off16 - off32)))
    # times: CUDA events, median of 20 calls after a warm-up
    feats = loftr_native.encode(model, xd)
    stack = feats[torch.arange(8, device=dev) % 2]
    rec["encode_ms"] = _cuda_ms(lambda: loftr_native.encode(model, xd[:1]))
    rec["confidence_ms"] = _cuda_ms(
        lambda: loftr_native.confidence_from_features(model, feats[:1], feats[1:]))
    rec["match_one_against_many_8_ms"] = _cuda_ms(
        lambda: loftr_native.match_one_against_many(model, feats[1:], stack, m.max_matches))
    with loftr_f32():
        rec["encode_f32_ms"] = _cuda_ms(lambda: loftr_native.encode(model, xd[:1]))
        rec["confidence_f32_ms"] = _cuda_ms(
            lambda: loftr_native.confidence_from_features(model, feats[:1], feats[1:]))
    if not (rec["f32_vs_cpu_max_abs"] < 1e-5 and rec["f32_vs_cpu_argmax_agreement"] > 0.999):
        raise AssertionError(f"the card's f32 LoFTR differs from the CPU's: {rec}")
    if rec["bf16_vs_f32_argmax_agreement_strong"] < MIN_LOFTR_BF16_ARGMAX:
        raise AssertionError(f"the card's bf16 LoFTR moved the strong matches: {rec}")
    if min(rec["many_vs_serial_jaccard"]) < MIN_LOFTR_MANY_JACCARD:
        raise AssertionError(f"match_against_many differs from serial matches: {rec}")
    if not (np.isfinite(off16).all() and np.abs(off16).max() <= 8.0 + 1e-3):
        raise AssertionError(f"fine_refine offsets leave the cell: {rec}")
    return rec


@contextlib.contextmanager
def capture_pose_problems(n_slots: int, keep: int = 2):
    """Record (copies of) the first `keep` pose_opt.pose_optimize problems
    of n_slots edge slots, without changing what is computed."""
    real = pose_opt.pose_optimize
    got: list = []

    def spy(*args):
        if len(got) < keep and args[1].shape[0] == n_slots:
            got.append([a.clone() for a in args])
        return real(*args)

    with mock.patch.object(pose_opt, "pose_optimize", spy):
        yield got


def check_b2_loftr(prob) -> dict:
    """Phase b2_loftr: kernel B2 against its plain version on a problem taken
    from the fused LoFTR step (one slot per cell, the coarse-cell
    information weight), then its bare, wrapper and plain times."""
    T0, X, uv, valid, K, info = prob
    rec = {"phase": "b2_loftr", "slots": int(X.shape[0]), "valid": int(valid.sum()),
           "info": float(info[0]),
           **compare_b2(pose_opt_cuda.pose_optimize_cuda(*prob),
                        pose_opt.pose_optimize_plain(*prob), "LoFTR step")}
    rec["ms"] = _per_launch_ms(b2_bare(*prob))
    rec["wrapper_ms"] = _per_launch_ms(lambda: pose_opt_cuda.pose_optimize_cuda(*prob))
    rec["plain_ms"] = _cuda_ms(lambda: pose_opt.pose_optimize_plain(*prob))
    rec["bound_ms"], rec["bound_by"] = b2_bound(rec["slots"], rec["valid"])
    return rec


def check_loftr_run(run: dict, kernels: bool) -> None:
    """A LoFTR System drive's bounds: it initializes, is never lost after,
    the frame ATE stays under MAX_LOFTR_ATE; no frame launches B1; the fused
    flows complete MIN_STEADY_SHARE of the timed frames in run_steady, each
    through two B2 launches on a card, and the pipelined mode consumes a
    speculative step on as many unless a keyframe event changed the window."""
    if run["first_ok_frame"] is None:
        raise AssertionError("the LoFTR System never initialized")
    if run["lost_frames"] or run["not_ok_after_first_ok"]:
        raise AssertionError(f"LoFTR tracking was lost: {run['states']}")
    if not run["ate_frames"] <= MAX_LOFTR_ATE:
        raise AssertionError(f"LoFTR frame ATE {run['ate_frames']}")
    if run["launches"]["b1"]:
        raise AssertionError(f"the LoFTR System launched B1: {run['launches']}")
    n_tracked = run["frames"] - run["first_ok_frame"] - 1
    if kernels and run["launches"]["b2"] < n_tracked:
        raise AssertionError(f"B2 launches {run['launches']} over {n_tracked} tracked frames")
    if run["flow"] == "unfused":
        return
    if run["timed_paths"]["run_steady"] < MIN_STEADY_SHARE * run["timed_frames"]:
        raise AssertionError(f"fused LoFTR completed {run['timed_paths']} of "
                             f"{run['timed_frames']} timed frames: {run['fused_stats']}")
    if run["flow"] == "pipelined":
        # a keyframe event changes the window, and the next dispatches are
        # skipped by design (skip_ctx_changed, as in the JAX package): every
        # other timed frame must consume its speculative step
        st = run["timed_stats"]
        if st.get("hit", 0) + st.get("skip_ctx_changed", 0) < \
                MIN_STEADY_SHARE * run["timed_frames"]:
            raise AssertionError(f"pipelined LoFTR hits {st} over {run['timed_frames']} "
                                 "timed frames")
    if kernels and run["flow"] == "fused":
        bad = [i for i, (p, n) in enumerate(zip(run["frame_path"], run["frame_launches"]))
               if p == "done_steady" and n != {"b1": 0, "b2": 2}]
        if bad:
            raise AssertionError(f"fused LoFTR frames {bad} launched "
                                 f"{[run['frame_launches'][i] for i in bad]}")


def loftr_system_phases(dev, cfg: SystemConfig = SYSTEM_LOFTR) -> dict:
    """Phases system_loftr (reference-twin flow), system_loftr_fused (the
    one-step fused_loftr path), system_loftr_pipelined and b2_loftr (see the
    module docstring). Returns the drives' launches."""
    kernels = dev.type == "cuda"
    world, poses, images = render_system(cfg._replace(n_timed=cfg.n_timed + PROFILE_FRAMES))
    runs, launches, problems = {}, {"b1": 0, "b2": 0}, []
    names = {"unfused": "system_loftr", "fused": "system_loftr_fused",
             "pipelined": "system_loftr_pipelined"}
    for flow in ("unfused", "fused", "pipelined"):
        sync_check = sync_free_dispatch() if kernels and flow == "pipelined" else \
            contextlib.nullcontext({"dispatches": None})
        capture = capture_pose_problems(LOFTR_B2_SLOTS) if flow == "fused" else \
            contextlib.nullcontext([])
        with sync_check as checked, capture as got:
            run, prof = profile_tail(dev, cfg, world, poses, images, flow, PROFILE_FRAMES,
                                     matcher="loftr")
        problems += got
        runs[flow] = run
        for k in launches:
            launches[k] += run["launches_total"][k]
        rec = {"phase": names[flow], "matcher": "loftr", **system_record(run),
               "states": run["states"], "frame_path": run["frame_path"], "profile": prof}
        if flow == "fused":
            rec["pair_ate_vs_unfused"], rec["pair_frames"] = trajectory_pair(
                run["system"], runs["unfused"]["system"])
        if flow == "pipelined":
            rec["pair_ate_vs_fused"], rec["pair_frames"] = trajectory_pair(
                run["system"], runs["fused"]["system"])
            rec["sync_free_dispatches"] = checked["dispatches"]
        _print(rec)
        check_loftr_run(run, kernels)
        if "pair_frames" in rec:
            pair = rec.get("pair_ate_vs_unfused", rec.get("pair_ate_vs_fused"))
            if not (pair < MAX_LOFTR_PAIR_ATE and rec["pair_frames"] >= 10):
                raise AssertionError(f"{names[flow]}: trajectory pair ATE {pair} over "
                                     f"{rec['pair_frames']} frames")
        if kernels and flow == "pipelined" and not checked["dispatches"]:
            raise AssertionError("no LoFTR dispatch ran under the sync debug mode")
    if not problems:
        raise AssertionError("the fused LoFTR drive handed B2 no 1200-slot problem")
    b2 = check_b2_loftr(problems[-1]) if kernels else None
    if b2 is not None:
        _print(b2)
    return {"launches": launches, "b2": b2}


def run_quality_loftr(device, n_poses: int = QUALITY_LOFTR_POSES) -> dict:
    """quality_bench.run_quality_loftr's regime with the port's classes: the
    smooth rect-loop world at 320x240 (resized to the model's 480x640), its
    first n_poses poses, LoftrFeatureMatcher(threshold=0.1, fine=False),
    minIniMatchCount=40, set_minimum_keyframes(0), the initialization gate
    re-pressed whenever the state is NO_IMAGES_YET; the default fused flow."""
    world = sim.PlaneWorld(plane_z=2.0, second_plane=sim.RECT_LOOP_PLANES, texture="smooth")
    poses = sim.rect_loop_trajectory(3.0, 2.2, LOOP_FULL.step)[:n_poses]
    images = [world.render(T) for T in poses]
    reset_frame_ids()
    reset_map_ids()
    params = SlamParameters(fx=world.f, fy=world.f, cx=world.cx, cy=world.cy,
                            minIniMatchCount=40, initializerModelFallback=True)
    matcher = LoftrFeatureMatcher(threshold=LOFTR_THRESHOLD, fine=False, device=device)
    system = System(params, matcher, KeyFrameMatchDatabase(matcher), verbose=False,
                    device=device)
    system.toggle_initialization_allowed()
    system.set_minimum_keyframes(0)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda *_: None)
    real_many = matcher.match_against_many
    many_calls = []

    def many(frame, others):
        many_calls.append(len(others))
        return real_many(frame, others)

    matcher.match_against_many = many
    _reset_launches()
    gt_t, gt_p, states, frame_ms = [], [], [], []
    t_drive = time.perf_counter()
    for i, T in enumerate(poses):
        t0 = time.perf_counter()
        system.track_monocular(images[i], i * 0.1)
        sync()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        gt_t.append(i * 0.1)
        gt_p.append(-(T[:3, :3].T @ T[:3, 3]))
        if system.tracker.state.name == "NO_IMAGES_YET":
            system.toggle_initialization_allowed()
        states.append(system.tracker.state.name)
    wall_s = time.perf_counter() - t_drive
    finite, ortho = pose_ortho_errors(system) if system.map.n_keyframes() else (True, 0.0)
    stats = fused_host.pipe_stats(system.tracker)
    return {
        "phase": "quality_loftr", "poses": len(poses), "size": [world.h, world.w],
        "states": "".join(s[0] for s in states),
        "ok_share": states.count("OK") / len(states),
        "first_ok_frame": states.index("OK") if "OK" in states else None,
        "final_state": states[-1], "final_ate": frame_ate(system, gt_t, gt_p),
        "keyframes": system.map.n_keyframes(), "map_points": system.map.n_map_points(),
        "match_against_many_calls": len(many_calls),
        "match_against_many_keyframes": sum(many_calls),
        "poses_finite": finite, "max_ortho_err": ortho,
        "launches": _launches(), "fps": len(states) / wall_s, "wall_s": wall_s,
        "frame_p50_ms": _pct(frame_ms, 50), "frame_p95_ms": _pct(frame_ms, 95),
        "fused_stats": {k: v for k, v in stats.items() if not k.endswith("_samples_ms")},
    }


def check_quality_loftr(rec: dict) -> None:
    """The LoFTR quality drive's bounds: it initializes, grows a map of at
    least two keyframes, scans the keyframe database in batched calls, and
    keeps every keyframe pose finite and orthonormal. Its OK share and ATE
    are recorded: the JAX package has no record of this drive to hold them
    to (BENCH_r05 skipped it)."""
    if rec["first_ok_frame"] is None or rec["keyframes"] < 2:
        raise AssertionError(f"the LoFTR quality drive built no map: {rec}")
    if rec["match_against_many_calls"] < 1:
        raise AssertionError(f"the LoFTR quality drive made no batched match: {rec}")
    if not rec["poses_finite"] or rec["max_ortho_err"] >= MAX_ORTHO_ERR:
        raise AssertionError(f"LoFTR quality keyframe poses: {rec}")


def _print(rec):
    print(json.dumps(rec), flush=True)


def _kernel_name(mangled: str) -> str:
    """pose_lm_kernel<8> for _ZN..14pose_lm_kernelILi8EEEv..., detect_kernel
    for _ZN..13detect_kernelE..."""
    m = re.search(r"([a-z_]+_kernel)(?:ILi(\d+)E)?", mangled)
    if not m:
        return mangled
    return f"{m.group(1)}<{m.group(2)}>" if m.group(2) else m.group(1)


def check_ptxas(ptxas: dict) -> None:
    """The build gate: every instance of kernel B2 keeps its state in
    registers (no stack frame, no spill), as its design needs."""
    lm = {k: v for k, v in ptxas.items() if k.startswith("pose_lm_kernel")}
    bad = {k: v for k, v in lm.items()
           if v["stack_frame"] or v["spill_stores"] or v["spill_loads"]}
    if len(lm) != len(pose_opt_cuda.CLUSTERS) or bad:
        raise AssertionError(f"ptxas: pose_lm_kernel instances {lm}, with stack or spill {bad}")


def fused_phases(dev, sys_cfg: SystemConfig, kf_cfg: SystemConfig, world_s, poses_s,
                 images_s, run: dict) -> dict:
    """Phases system_fused, system_pipelined and system_fused_kf (see the
    module docstring); `run` is the `system` phase's drive through the
    kernels, in the unfused flow. Returns the three drives' launches."""
    kernels = dev.type == "cuda"

    # ---- the default fused flow: run_steady, then run, then the host path ----
    fused = run_system(dev, sys_cfg, world_s, poses_s, images_s, flow="fused")
    with plain_kernels():
        fused_plain = run_system(dev, sys_cfg, world_s, poses_s, images_s, flow="fused")
    pair, n_pair = trajectory_pair(fused["system"], run["system"])
    both = ~np.isnan(fused["Tcw"][:, 0, 0]) & ~np.isnan(fused_plain["Tcw"][:, 0, 0])
    pose_diff = np.abs(fused["Tcw"][both] - fused_plain["Tcw"][both]).max(axis=(1, 2))
    _print({"phase": "system_fused", **system_record(fused),
            "plain": system_record(fused_plain),
            "plain_pose_max_abs_diff_per_frame": pose_diff.tolist(),
            "pair_ate_vs_unfused": pair, "pair_frames": n_pair,
            "unfused_frame_p50_ms": run["frame_p50_ms"]})
    check_fused_run(fused, kernels=kernels)
    check_fused_run(fused_plain, kernels=False)
    if not (pair < MAX_FUSED_PAIR_ATE and n_pair >= 10):
        raise AssertionError(f"fused vs unfused trajectories: ATE {pair} over {n_pair} frames")
    _print({"phase": "checkpoint", **checkpoint_round_trip(dev, sys_cfg, world_s, fused["system"])})

    # ---- the pipelined mode: track_monocular_pipelined + flush_pipeline ----
    # every dispatch on a card runs under the sync debug mode (the CPU has none)
    checker = sync_free_dispatch() if kernels else contextlib.nullcontext({"dispatches": None})
    with checker as checked:
        pipe = run_system(dev, sys_cfg, world_s, poses_s, images_s, flow="pipelined")
    pair_p, n_pair_p = trajectory_pair(pipe["system"], fused["system"])
    st = pipe["fused_stats"]
    misses = sum(v for k, v in st.items() if k.startswith("miss_"))
    _print({"phase": "system_pipelined", **system_record(pipe),
            "pair_ate_vs_fused": pair_p, "pair_frames": n_pair_p,
            "sync_free_dispatches": checked["dispatches"]})
    if pipe["lost_frames"] or pipe["not_ok_after_first_ok"] or pipe["first_ok_frame"] is None:
        raise AssertionError(f"pipelined tracking was lost: {pipe['states']}")
    if pipe["timed_stats"].get("hit", 0) < MIN_STEADY_SHARE * pipe["timed_frames"]:
        raise AssertionError(f"pipelined hits {pipe['timed_stats']} over "
                             f"{pipe['timed_frames']} timed frames")
    if st["hit"] + misses > st["dispatch"]:
        raise AssertionError(f"hits + misses exceed dispatches: {st}")
    if not (pair_p < MAX_PIPELINED_PAIR_ATE and n_pair_p >= 10):
        raise AssertionError(f"pipelined vs fused: ATE {pair_p} over {n_pair_p} frames")
    if kernels and checked["dispatches"] < 1:
        raise AssertionError("no dispatch_steady_spec ran under the sync debug mode")

    # ---- the keyframe-event regime: step 0.06, 8 warm + 30 timed ----
    world_k, poses_k, images_k = render_system(kf_cfg)
    kf_run = run_system(dev, kf_cfg, world_k, poses_k, images_k, flow="fused")
    _print({"phase": "system_fused_kf", **system_record(kf_run),
            "ctx_builds_timed": kf_run["timed_stats"].get("ctx_builds", 0)})
    if kf_run["lost_frames"] or kf_run["not_ok_after_first_ok"] or kf_run["first_ok_frame"] is None:
        raise AssertionError(f"keyframe regime tracking was lost: {kf_run['states']}")
    if kf_run["kf_events"] < 1:
        raise AssertionError("no keyframe event in the keyframe regime's timed window")
    return {k: sum(r["launches"][k] for r in (fused, pipe, kf_run)) for k in ("b1", "b2")}


def reloc_loop_phase(dev, cfg: LoopConfig) -> dict:
    """Phase reloc_loop (see the module docstring). Returns the quality
    drive's launches."""
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    world, poses, images = render_loop(cfg)  # before any timing
    run = run_loop_drive(dev, cfg, world, poses, images)
    surgical = {}
    for prealign in (False, True):
        setup = surgical_loop_setup(dev, cfg.max_features, prealign,
                                    SURGICAL_DRIFT if prealign else None)
        key = "prealign_on" if prealign else "prealign_off"
        surgical[key] = run_surgical_loop(setup, sync)
    rec = {k: v for k, v in run.items() if k not in ("system", "states")}
    _print({"phase": "reloc_loop", **rec, "states_head": run["states"][:cfg.drop_at + 8],
            "surgical": surgical})
    check_loop_drive(run, kernels=dev.type == "cuda")
    return run["launches"]


# ---------------------------------------------------------------------------
# the application layer: native runtime, dataset runner, A/B sweep,
# interactive driver, quality bench, and the observation graph's cost


def card(dev) -> str:
    """What the times of a phase on `dev` were taken on: nvidia-smi's name
    and power limit of the card, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def native_phase(dev) -> dict:
    """Phase native: build both native libraries (g++, into _build/) and
    run the observation graph's raw API. A machine where they do not build
    would silently run the Python covisibility scan and PIL decoding."""
    graph, fio = native.load_library(), frameio.load_library()
    if graph is None or fio is None:
        raise AssertionError(f"native libraries did not build: {native.build_errors}")
    g = native.ObservationGraph()
    checks = [g.add(1, 10), not g.add(1, 10), g.add(1, 11), g.add(2, 10),
              g.covis_counts(10) == {11: 1}, g.n_obs_kf(10) == 2, g.erase(1, 10),
              g.covis_counts(10) == {}]
    g.erase_map_point(2)
    checks.append(g.n_obs_kf(10) == 0)
    if not all(checks):
        raise AssertionError(f"observation graph raw API: {checks}")
    return {"phase": "native", "card": card(dev), "build_seconds": dict(native.build_seconds),
            "libraries": [str(native.library_path("slamgraph.cc")),
                          str(native.library_path("frameio.cc", frameio.LIBS))]}


def png_gray(img: np.ndarray) -> bytes:
    """An 8-bit grayscale PNG of `img` (uint8 [H, W]), with zlib and struct
    only: the card's machine need not have an image library."""
    h, w = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))  # filter 0 per row
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_tum_sequence(root, world, poses, images) -> list:
    """A TUM RGB-D directory of the rendered drive: rgb/<t>.png as 8-bit
    grayscale, rgb.txt and groundtruth.txt (camera centres, 0.1 s apart).
    Returns the frames as written (uint8)."""
    root = pathlib.Path(root)
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    lines, gt, frames = [], [], []
    for i, (T, img) in enumerate(zip(poses, images)):
        ts = f"{i * 0.1:.6f}"
        u8 = np.clip(img, 0, 255).astype(np.uint8)
        (root / "rgb" / f"{ts}.png").write_bytes(png_gray(u8))
        frames.append(u8)
        lines.append(f"{ts} rgb/{ts}.png")
        Ow = -(T[:3, :3].T @ T[:3, 3])
        gt.append(f"{ts} {Ow[0]:.6f} {Ow[1]:.6f} {Ow[2]:.6f} 0 0 0 1")
    (root / "rgb.txt").write_text("# timestamp filename\n" + "\n".join(lines) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(gt) + "\n")
    return frames


def cli_argv(root, world, cfg: SystemConfig, device, *extra) -> list:
    """run.main's arguments for the rendered TUM drive (bench.py's ORB
    System: ratio 0.7, the initializer's model fallback)."""
    return ["--dataset", "tum", "--path", str(root),
            "--fx", str(world.f), "--fy", str(world.f),
            "--cx", str(world.cx), "--cy", str(world.cy),
            "--features", str(cfg.max_features), "--ratio", str(RATIO), "--model-fallback",
            "--device", str(device), *extra]


@contextlib.contextmanager
def recorded_systems():
    """The port's System, as the entry points import it, replaced by a
    subclass that keeps every instance and its tracker's state after each
    frame it completes (`states`; the pipelined mode completes each frame
    through track_monocular too); yields the list of instances."""
    made = []

    class Recorded(System):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.states = []
            made.append(self)

        def track_monocular(self, image, timestamp):
            super().track_monocular(image, timestamp)
            self.states.append(self.tracker.state.name)

    with mock.patch.object(slam_pkg, "System", Recorded):
        yield made


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def run_cli(device, root, world, cfg: SystemConfig, *extra) -> dict:
    """run.main over the TUM directory, in-process: its printed summary, the
    System it built, the launches and the states of its frame calls."""
    with tempfile.TemporaryDirectory() as d, recorded_systems() as made:
        out, ckpt = f"{d}/traj.txt", f"{d}/map.npz"
        buf = io.StringIO()
        _reset_launches()
        with contextlib.redirect_stdout(buf):
            runner.main(cli_argv(root, world, cfg, device, "--quiet", "--ate", "--out", out,
                                 "--map-out", ckpt, *extra))
        launches = _launches()
        summary = _last_json(buf.getvalue())
        (system,) = made
        other = build_system(device, cfg, world, "fused")
        other.load_checkpoint(ckpt)
        loaded = {"keyframes": other.map.n_keyframes(), "map_points": other.map.n_map_points(),
                  "with_connections": sum(bool(kf.connections)
                                          for kf in other.map.all_keyframes())}
    return {"summary": summary, "system": system, "states": system.states,
            "launches": launches, "loaded": loaded}


def check_cli_run(rec: dict, n_frames: int, kernels: bool, max_ate: float) -> None:
    """run_cli's bounds: every frame read, >= 2 keyframes, ends OK with the
    keyframe ATE within max_ate, the checkpoint reloads with the map's
    counts and covisibility, the System kept its observations in the native
    graph, and through the kernels B1 ran at least once per frame after the
    first OK one and B2 at least twice per tracked frame."""
    s, states = rec["summary"], rec["states"]
    if s["frames"] != n_frames or s["keyframes"] < 2 or s["final_state"] != "OK":
        raise AssertionError(f"run.main summary {s}")
    if not s["ate_rmse"] <= max_ate:
        raise AssertionError(f"run.main keyframe ATE {s['ate_rmse']} > {max_ate}")
    loaded = rec["loaded"]
    if (loaded["keyframes"], loaded["map_points"]) != (s["keyframes"], s["map_points"]) \
            or loaded["with_connections"] != loaded["keyframes"]:
        raise AssertionError(f"the --map-out checkpoint reloads as {loaded}; summary {s}")
    if rec["system"].map.obs_graph is None:
        raise AssertionError("the runner's System scanned covisibility in Python")
    if "OK" not in states:
        raise AssertionError(f"states {states}")
    first_ok = states.index("OK")
    after, tracked = len(states) - first_ok, len(states) - first_ok - 1
    if kernels and (rec["launches"]["b1"] < after or rec["launches"]["b2"] < 2 * tracked):
        raise AssertionError(f"launches {rec['launches']} over {after} frames from the "
                             f"first OK one, {tracked} tracked")


def decode_ms(root, paths) -> dict:
    """Which decoder serves the frames, and the ms per frame of reading the
    whole sequence through the loader with the prefetcher and without."""
    native_ok = [frameio.decode(p) is not None for p in paths]
    rec = {"decoder": "native" if all(native_ok) else "PIL" if not any(native_ok) else "mixed"}
    for prefetch in (4, 0):
        t0 = time.perf_counter()
        n = sum(1 for _ in datasets.load_tum(str(root), prefetch=prefetch))
        rec[f"decode_ms_per_frame_prefetch_{prefetch}"] = (time.perf_counter() - t0) * 1e3 / n
    return rec


# Bound of the CLI drive's keyframe ATE: three times the worst of the same
# drive with the plain versions on a CPU (run.main --device cpu over the
# 8-bit PNGs of SYSTEM_FULL's 42 frames, fused and --pipelined, on the H100
# machine's host: ate_rmse 0.0018 over 3 keyframes in both, OK from frame 5).
# The PNGs quantize the frames, so MAX_FUSED_*_ATE (in-memory f32 frames)
# does not apply.
MAX_CLI_ATE = 3 * 0.0018


def cli_phases(dev, cfg: SystemConfig, world, poses, images, max_ate: float = MAX_CLI_ATE):
    """Phases run_cli and ab_sweep over one TUM directory of the rendered
    drive. Returns the directory's handle, the decoded frames' record and the
    phases' launches."""
    kernels = dev.type == "cuda"
    tmp = tempfile.TemporaryDirectory()
    root = pathlib.Path(tmp.name)
    written = write_tum_sequence(root, world, poses, images)
    paths = sorted(str(p) for p in (root / "rgb").glob("*.png"))
    first = datasets._load_gray(paths[0])
    if not np.array_equal(first, written[0].astype(np.float32)):
        raise AssertionError("the first frame does not decode to the pixels written")
    launches = collections.Counter()
    for flow, extra in (("fused", ()), ("pipelined", ("--pipelined",))):
        rec = run_cli(dev, root, world, cfg, *extra)
        launches.update(rec["launches"])
        _print({"phase": "run_cli", "card": card(dev), "flow": flow, **rec["summary"],
                "states": "".join(st[0] for st in rec["states"]),
                "launches": rec["launches"], "loaded_checkpoint": rec["loaded"],
                "native_graph": rec["system"].map.obs_graph is not None,
                "fused_stats": {k: v for k, v in fused_host.pipe_stats(
                    rec["system"].tracker).items() if not k.endswith("_samples_ms")},
                "max_ate": max_ate, **(decode_ms(root, paths) if flow == "fused" else {})})
        check_cli_run(rec, len(images), kernels, max_ate)

    # ---- the A/B sweep: ORB and LoFTR over the same directory ----
    buf = io.StringIO()
    _reset_launches()
    with contextlib.redirect_stdout(buf):
        results = ab_sweep.main(cli_argv(
            root, world, cfg, dev, "--matchers", "orb,loftr", "--ate",
            "--min-ini-matches", str(LOFTR_MIN_INI_MATCHES),
            "--out-prefix", str(root / "ab")))
    launches.update(_launches())
    printed = json.loads(buf.getvalue())["sweep"]
    _print({"phase": "ab_sweep", "card": card(dev), "launches": _launches(),
            "arms": [{k: r[k] for k in ("matcher", "frames", "fps", "keyframes", "map_points",
                                        "lost_frames", "final_state", "ate_rmse", "ate_pairs")}
                     for r in results]})
    if [r["matcher"] for r in printed] != ["orb", "loftr"] or any(
            r["final_state"] != "OK" or r["frames"] != len(images) for r in results):
        raise AssertionError(f"ab_sweep arms {results}")
    tmp.cleanup()
    return dict(launches)


@contextlib.contextmanager
def thread_errors():
    """Collect every exception that ends a thread (AsyncSlamDriver's worker
    only lets it reach threading.excepthook); the phase raises after."""
    errors: list = []
    real = threading.excepthook

    def hook(args):
        errors.append("".join(traceback.format_exception(
            args.exc_type, args.exc_value, args.exc_traceback)))

    threading.excepthook = hook
    try:
        yield errors
    finally:
        threading.excepthook = real


INTERACTIVE_KEYS = ["i"] + ["right"] * 3 + [""] * 25 + ["t"]
PACED_FRAMES = 40
PACE_S = 0.032  # the reference's camera period (src/main.cpp:58-59)


def paced_drive(dev, cfg: SystemConfig, world, images, flow: str) -> dict:
    """PACED_FRAMES of `images` fed every PACE_S from this thread through
    AsyncSlamDriver into a fused System, whose worker (a new thread per
    accepted frame) tracks with track_monocular or, flow="pipelined",
    track_monocular_pipelined (flushed after the last frame): frames dropped,
    the worker's ms and states per frame, the final state."""
    system = build_system(dev, cfg, world, "fused")
    system.toggle_initialization_allowed()
    step = system.track_monocular_pipelined if flow == "pipelined" else system.track_monocular
    track_ms, worker_states = [], []

    def track(image, timestamp):  # on the worker thread
        t = time.perf_counter()
        step(image, timestamp)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        track_ms.append((time.perf_counter() - t) * 1e3)
        worker_states.append(system.tracker.state.name)

    driver = AsyncSlamDriver(system, track_fn=track)
    _reset_launches()
    t0 = time.perf_counter()
    for i, img in enumerate(images[:PACED_FRAMES]):
        driver.feed(img, timestamp=i * PACE_S)
        time.sleep(max(0.0, t0 + (i + 1) * PACE_S - time.perf_counter()))
    driver.close()
    if flow == "pipelined":
        system.flush_pipeline()
    return {"frames_in": driver.frames_in, "frames_dropped": driver.frames_dropped,
            "final_state": system.tracker.state.name,
            "states": "".join(st[0] for st in worker_states),
            "track_ms": [round(x, 2) for x in track_ms],
            "keyframes": system.map.n_keyframes(), "wall_s": time.perf_counter() - t0,
            "launches": _launches()}


def interactive_phase(dev, cfg: SystemConfig, world, images) -> dict:
    """Phase interactive: interactive.main's scripted session (its world and
    System at cfg's size, no PNG), then `paced_drive` in the fused flow and
    pipelined. Fails on any exception in a worker thread. Returns the
    launches."""
    if dev.type == "cuda" and torch.cuda.get_sync_debug_mode() != 0:
        raise AssertionError("a sync debug mode was left set by an earlier phase")
    launches = collections.Counter()
    with thread_errors() as errors, tempfile.TemporaryDirectory() as d, \
            recorded_systems() as made:
        buf = io.StringIO()
        _reset_launches()
        with contextlib.redirect_stdout(buf):
            interactive.main(["--features", str(cfg.max_features), "--width", str(cfg.w),
                              "--height", str(cfg.h), "--focal", str(cfg.f), "--png", "",
                              "--keys", ",".join(INTERACTIVE_KEYS), "--out", f"{d}/traj.txt",
                              "--device", str(dev)])
        scripted = _last_json(buf.getvalue())
        scripted["launches"] = _launches()
        scripted["native_graph"] = made[0].map.obs_graph is not None
        launches.update(_launches())

        paced = {}
        for flow in ("fused", "pipelined"):
            paced[flow] = paced_drive(dev, cfg, world, images, flow)
            launches.update(paced[flow]["launches"])
    _print({"phase": "interactive", "card": card(dev), "scripted": scripted, "paced": paced,
            "thread_errors": errors})
    if errors:
        raise AssertionError(f"a worker thread raised:\n{errors[0]}")
    if (scripted["state"] != "OK" or scripted["keyframes"] < 2 or scripted["dropped"] != 0
            or scripted["frames"] != len(INTERACTIVE_KEYS) or not scripted["native_graph"]):
        raise AssertionError(f"scripted interactive session {scripted}")
    return dict(launches)


def quality_bench_phase(dev) -> dict:
    """Phase quality_bench: the port's quality_bench.run_quality (both arms,
    the full rect loop) and run_quality_loftr on `dev`. Fails on an error key
    or an ORB OK share under MIN_OK_SHARE; whether the loop fired and the
    fork arm's numbers are recorded (ROADMAP C.8: on this world they turn on
    float noise). Returns the launches."""
    _reset_launches()
    t0 = time.perf_counter()
    orb_arm = quality_bench.run_quality(device=dev, both_arms=True)
    t1 = time.perf_counter()
    loftr_arm = quality_bench.run_quality_loftr(device=dev)
    t2 = time.perf_counter()
    rec = {"phase": "quality_bench", "card": card(dev), **orb_arm, **loftr_arm,
           "launches": _launches(),
           "orb_seconds": t1 - t0, "loftr_seconds": t2 - t1}
    _print(rec)
    errors = {k: v for k, v in rec.items() if k.startswith("quality_error")}
    if errors or orb_arm["quality_frames_ok_share"] < MIN_OK_SHARE:
        raise AssertionError(f"quality_bench {rec}")
    return rec["launches"]


def pose_checksum(system: System) -> float:
    """The sum of |Tcw| over the keyframes: equal sums mean the same map."""
    kfs = sorted(system.map.all_keyframes(), key=lambda kf: kf.id)
    return float(sum(np.abs(kf.get_pose().astype(np.float64)).sum() for kf in kfs))


@contextlib.contextmanager
def connection_timer():
    """Time every KeyFrame.update_connections (host ms); yields the list."""
    real = map_model.KeyFrame.update_connections
    ms: list = []

    def timed(kf):
        t0 = time.perf_counter()
        real(kf)
        ms.append((time.perf_counter() - t0) * 1e3)

    with mock.patch.object(map_model.KeyFrame, "update_connections", timed):
        yield ms


KF_GRAPH_TURNS = (True, False, False, True)  # native graph on / off, in turns


def kf_graph_phase(dev, cfg: SystemConfig) -> dict:
    """Phase kf_graph: the keyframe-event regime (system_fused_kf's drive)
    with Map(use_native_graph=True) and with the Python scan, in turns:
    keyframe-event p50 / p95, update_connections ms per call, and whether
    the drives built the same map (pose checksums). Returns the launches."""
    world, poses, images = render_system(cfg)
    turns, launches = [], collections.Counter()
    for use_native in KF_GRAPH_TURNS:
        make = lambda: map_model.Map(use_native_graph=use_native)  # noqa: E731
        with mock.patch.object(system_mod, "Map", make), connection_timer() as uc_ms:
            run = run_system(dev, cfg, world, poses, images, flow="fused")
        system = run["system"]
        if (system.map.obs_graph is not None) != use_native:
            raise AssertionError("the drive did not run the graph it was given")
        if run["lost_frames"] or run["first_ok_frame"] is None:
            raise AssertionError(f"kf_graph drive lost track: {run['states']}")
        launches.update(run["launches"])
        turns.append({"native_graph": use_native, "kf_events": run["kf_events"],
                      "kf_event_p50_ms": run["kf_event_p50_ms"],
                      "kf_event_p95_ms": run["kf_event_p95_ms"],
                      "frame_p50_ms": run["frame_p50_ms"],
                      "update_connections_calls": len(uc_ms),
                      "update_connections_ms_per_call": float(np.mean(uc_ms)) if uc_ms else None,
                      "keyframes": run["keyframes"], "map_points": run["map_points"],
                      "pose_checksum": pose_checksum(system),
                      "Tcw": run["Tcw"]})
    native_t = [t for t in turns if t["native_graph"]]
    python_t = [t for t in turns if not t["native_graph"]]
    frame_diff = float(np.nanmax(np.abs(native_t[0]["Tcw"] - python_t[0]["Tcw"])))
    _print({"phase": "kf_graph", "card": card(dev), "size": [cfg.h, cfg.w], "step": cfg.step,
            "turns": [{k: v for k, v in t.items() if k != "Tcw"} for t in turns],
            "checksums_equal": len({t["pose_checksum"] for t in turns}) == 1,
            "frame_pose_max_abs_diff_native_vs_python": frame_diff})
    return dict(launches)


# ---------------------------------------------------------------------------
# multi-stream serving: the batched steady step and SlamServer


MULTI_STREAMS = 8  # bench.py::bench_multistream: 8 streams at 640x480, 2000 features
MULTI_TIMED = 30  # timed calls after one warm-up call
MULTI_OFFSET = 4  # stream s starts s * MULTI_OFFSET poses along one trajectory
MULTI_PLAIN_FRAMES = 5  # calls of the batch through the plain versions
MULTI_PROFILE_CALLS = 3
BATCH_SIZES = (1, 4, 8)  # streams / problems of the batched launches' bare times
MAX_MULTI_POSE_DIFF = 1e-4  # batched vs one-stream steady_step, T1 and T2
# bench.py::bench_server: 4 streams on PERF.md's world at steps 0.02 + 0.004 s
SERVER_STREAMS = 4
SERVER_WARM = 10
SERVER_TIMED = 24
SERVER_LOFTR_TIMED = 24
# LoFTR streams step by 0.001 (0.020 - 0.023): at bench_server's widest step,
# 0.032, the LoFTR System does not initialize on this world (server_loftr
# records it as bench_widest_step; ROADMAP C.15)
SERVER_LOFTR_STEP = 0.001
MAX_SERVER_ATE = 0.15  # tests/test_server.py:109
MAX_SERVER_PAIR_ATE = 0.05  # tests/test_server.py:114
# LoFTR streams: test_server.py's LoFTR case bounds the ATE at 0.2 (:234) and
# has no pair; the pair is held to the LoFTR System's (MAX_LOFTR_PAIR_ATE)
MAX_SERVER_LOFTR_ATE = 0.2


def multistream_setup(dev, cfg: Config = FULL, n_streams: int = MULTI_STREAMS,
                      n_calls: int = MULTI_TIMED + 1) -> dict:
    """N streams of the slice's regime (cfg's size, features, keyframes and
    table capacities), stream s on poses s * MULTI_OFFSET .. of one lateral
    trajectory, each with its map seeded from the simulator (seed_map).
    Returns the streams' images per call [n_calls] x [N, H, W] on the
    device, the stacked tables and the chain's start (the last keyframe)."""
    n_pose = cfg.n_kf + n_calls
    world, poses, images = render(cfg._replace(n_frames=n_calls + (n_streams - 1) * MULTI_OFFSET))
    seeds, starts = [], []
    for s in range(n_streams):
        sl = slice(s * MULTI_OFFSET, s * MULTI_OFFSET + n_pose)
        seed = seed_map(dev, cfg, world, poses[sl], images[sl])
        seeds.append(seed)
        starts.append(poses[sl])
    last = cfg.n_kf - 1
    st = lambda xs: torch.stack(list(xs))  # noqa: E731
    feats = lambda fs: orb.Features(*(st(x) for x in zip(*fs)))  # noqa: E731
    frames = [torch.from_numpy(np.stack([images[s * MULTI_OFFSET + cfg.n_kf + t]
                                         for s in range(n_streams)])).to(dev)
              for t in range(n_calls)]
    return {
        "cfg": cfg, "n": n_streams, "frames": frames,
        "gt": np.stack([np.stack(p[cfg.n_kf:]) for p in starts], 1),  # [calls, N, 4, 4]
        "tables": (st(x.mp_pos for x in seeds), feats(x.kf_feats for x in seeds),
                   st(x.kf_px for x in seeds), st(x.kf_row for x in seeds),
                   st(x.first_slot for x in seeds), st(x.normal for x in seeds),
                   st(x.maxdist for x in seeds), st(x.K for x in seeds)),
        "start": (feats(x.feats[last] for x in seeds), st(x.kf_px[last] for x in seeds),
                  st(x.kf_row[last] for x in seeds),
                  torch.from_numpy(np.stack([p[last] for p in starts])).to(dev),
                  torch.from_numpy(np.stack([p[last - 1] for p in starts])).to(dev)),
    }


def multistream_drive(ms: dict, n_calls: int) -> list:
    """n_calls chained multistream.steady_step_batch calls over all N
    streams (each stream chained as `drive` chains one). Returns the
    SteadyOuts."""
    cfg = ms["cfg"]
    mp_pos, kf_feats, kf_px, kf_row, first_slot, normal, maxdist, K = ms["tables"]
    prev_feats, prev_px, prev_row, T_prev, T_prev2 = ms["start"]
    outs = []
    for t in range(n_calls):
        out = multistream.steady_step_batch(
            ms["frames"][t], prev_feats, prev_px, prev_row, mp_pos,
            fused_tracking.chain_T_init(T_prev, T_prev2), kf_feats, kf_px, kf_row, first_slot,
            normal, maxdist, K, RATIO, cfg.w, float(cfg.w), float(cfg.h), True,
            cfg.max_features, FAST_THRESHOLD,
        )
        prev_feats, prev_px, prev_row = out.cur, out.chain_px, out.union_row
        T_prev2, T_prev = T_prev, out.local.T2
        outs.append(out)
    return outs


def single_stream_drives(ms: dict, n_calls: int) -> list:
    """The same chains as multistream_drive, one fused_tracking.steady_step
    call per stream and frame. Returns [calls][streams] SteadyOuts."""
    cfg = ms["cfg"]
    tables = ms["tables"]
    start = ms["start"]
    chains = [[orb.Features(*(x[s] for x in start[0]))] + [x[s] for x in start[1:]]
              for s in range(ms["n"])]
    outs = []
    for t in range(n_calls):
        row = []
        for s, ch in enumerate(chains):
            prev_feats, prev_px, prev_row, T_prev, T_prev2 = ch
            mp_pos, kf_feats, kf_px, kf_row, first_slot, normal, maxdist, K = (
                orb.Features(*(f[s] for f in x)) if isinstance(x, orb.Features) else x[s]
                for x in tables)
            out = fused_tracking.steady_step(
                ms["frames"][t][s], prev_feats, prev_px, prev_row, mp_pos,
                fused_tracking.chain_T_init(T_prev, T_prev2), kf_feats, kf_px, kf_row,
                first_slot, normal, maxdist, K, RATIO, cfg.w, float(cfg.w), float(cfg.h), True,
                cfg.max_features, FAST_THRESHOLD,
            )
            ch[:] = [out.cur, out.chain_px, out.union_row, out.local.T2, T_prev]
            row.append(out)
        outs.append(row)
    return outs


def compare_streams(batched: list, singles: list) -> dict:
    """Each stream of each batched call against its one-stream step: the
    association rows, the chain and the inlier counts equal, T1 and T2
    within MAX_MULTI_POSE_DIFF."""
    rows_equal, pose = True, 0.0
    for out, row in zip(batched, singles):
        for s, one in enumerate(row):
            for a, b in ((out.motion.row, one.motion.row), (out.local.new_row, one.local.new_row),
                         (out.union_row, one.union_row), (out.chain_px, one.chain_px),
                         (out.motion.n_good, one.motion.n_good),
                         (out.local.n_good, one.local.n_good), (out.local.vis, one.local.vis)):
                rows_equal &= bool(torch.equal(a[s], b.to(a.dtype)))
            for a, b in ((out.motion.T1, one.motion.T1), (out.local.T2, one.local.T2)):
                pose = max(pose, float((a[s] - b).abs().max()))
    return {"rows_and_n_good_equal": rows_equal, "pose_max_abs_diff": pose}


def device_ops(fn, n: int) -> float:
    """Device operations (kernels and copies) per call of fn, from
    torch.profiler over n calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()) / n


def multistream_phase(dev) -> dict:
    """Phase multistream (bench.py::bench_multistream's regime on the slice's
    seeded maps): N = 8 streams at 640x480, 2000 features, tables of 1024,
    8 local keyframes; 30 timed batched calls after one warm-up, and the
    same inputs as 8 one-stream steady_step calls per frame, in turns
    (batched, one-stream, one-stream, batched). Every stream of every call
    is held against its one-stream step, the batch against its plain
    kernels over MULTI_PLAIN_FRAMES calls, and the launches per call are
    counted (B1 once, B2 twice). Returns the record with the batched
    launches' bare times."""
    ms = multistream_setup(dev)
    cfg, n, calls = ms["cfg"], ms["n"], MULTI_TIMED + 1
    sync = lambda: torch.cuda.synchronize(dev)  # noqa: E731

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    multistream_drive(ms, 1)  # warm-up
    single_stream_drives(ms, 1)
    _reset_launches()
    batched, ms_b1 = timed(lambda: multistream_drive(ms, calls))
    launches = _serving_launches()
    singles, ms_s1 = timed(lambda: single_stream_drives(ms, calls))
    _, ms_s2 = timed(lambda: single_stream_drives(ms, calls))
    _, ms_b2 = timed(lambda: multistream_drive(ms, calls))
    agree = compare_streams(batched, singles)
    with plain_kernels():
        plain = multistream_drive(ms, MULTI_PLAIN_FRAMES)
    plain_pose = max(float((a.local.T2 - b.local.T2).abs().max())
                     for a, b in zip(batched, plain))
    plain_rows = float(np.mean([float((a.union_row == b.union_row).float().mean())
                                for a, b in zip(batched, plain)]))
    T2 = torch.stack([o.local.T2 for o in batched]).cpu().numpy()
    c_err, r_err = pose_errors(T2.reshape(-1, 4, 4), ms["gt"][:calls].reshape(-1, 4, 4))
    ops_batched = device_ops(lambda: multistream_drive(ms, 1), MULTI_PROFILE_CALLS)
    ops_single = device_ops(lambda: single_stream_drives(ms, 1), MULTI_PROFILE_CALLS)

    # the batched launches alone: B1 over N streams' stacks, B2 over B problems
    dims = orb._level_dims(cfg.h, cfg.w)
    stacks = torch.stack([orb.pyramid(img) for img in ms["frames"][0]])
    b1_ms = {k: _per_launch_ms(b1_bare(stacks[:k].contiguous(), dims)) for k in BATCH_SIZES}
    b1_bounds = {k: b1_bound(dims, stacked=True, n_streams=k) for k in BATCH_SIZES}
    b2_ms, b2_bounds = {}, {}
    for k in BATCH_SIZES:
        prob = b2_batch_problems_steady(k)
        args = [torch.from_numpy(a).to(dev) for a in prob]
        b2_ms[k] = _per_launch_ms(b2_bare(*args))
        b2_bounds[k] = b2_bound(prob[1].shape[1], int(prob[3].sum()), k)
    per_call = [ms_b1 / calls, ms_b2 / calls]
    per_single = [ms_s1 / calls, ms_s2 / calls]
    rec = {
        "phase": "multistream", "card": card(dev), "streams": n, "size": [cfg.h, cfg.w],
        "max_features": cfg.max_features, "cap": cfg.cap, "local_keyframes": cfg.n_kf,
        "timed_calls": calls, "ms_per_call": per_call,
        "aggregate_fps": [n * 1e3 / x for x in per_call],
        "per_stream_fps": [1e3 / x for x in per_call],
        "single_ms_per_frame_of_8": per_single,
        "single_aggregate_fps": [n * 1e3 / x for x in per_single],
        "launches": launches, "b1_batch_per_call": launches["b1_batch"] / calls,
        "b2_per_call": launches["b2"] / calls,
        "device_ops_per_call": ops_batched, "device_ops_per_8_single_steps": ops_single,
        **agree, "plain_frames": MULTI_PLAIN_FRAMES, "plain_pose_max_abs_diff": plain_pose,
        "plain_union_row_agreement": plain_rows,
        "max_center_err_m": float(c_err.max()), "max_rot_err_deg": float(r_err.max()),
        "b1_batch_bare_ms": b1_ms, "b1_batch_bound_ms": {k: v[0] for k, v in b1_bounds.items()},
        "b2_batch_bare_ms": b2_ms, "b2_batch_bound_ms": {k: v[0] for k, v in b2_bounds.items()},
        "b2_batch_bound_by": {k: v[1] for k, v in b2_bounds.items()},
    }
    _print(rec)
    if launches != {"b1": 0, "b1_batch": calls, "b2": 2 * calls}:
        raise AssertionError(f"multistream launches {launches} over {calls} calls")
    if not agree["rows_and_n_good_equal"] or agree["pose_max_abs_diff"] > MAX_MULTI_POSE_DIFF:
        raise AssertionError(f"batched streams differ from one-stream steps: {agree}")
    if not plain_pose <= 1e-3:
        raise AssertionError(f"the batch and its plain kernels differ by {plain_pose}")
    if c_err.max() > MAX_CENTER_ERR or r_err.max() > MAX_ROT_ERR_DEG:
        raise AssertionError(f"multistream pose error {c_err.max()} m, {r_err.max()} deg")
    return rec


def render_server(n_streams: int, n_frames: int, step: float = 0.004):
    """bench.py::bench_server's frames: PERF.md's world at 640x480, stream s
    on a lateral trajectory with step 0.02 + step * s."""
    world = sim.PlaneWorld(width=640, height=480, f=500.0, second_plane=(3.0, 0.3))
    trajs = [sim.lateral_trajectory(n_frames, step=0.02 + step * s) for s in range(n_streams)]
    return world, trajs, [[world.render(T) for T in traj] for traj in trajs]


def server_params(world, matcher: str) -> SlamParameters:
    """bench_server's parameters: the fused one-step defaults, 2000 features;
    LoFTR with minIniMatchCount 60."""
    return SlamParameters(
        fx=world.f, fy=world.f, cx=world.cx, cy=world.cy, max_features=2000,
        minIniMatchCount=LOFTR_MIN_INI_MATCHES if matcher == "loftr" else 100,
        initializerModelFallback=True, fusedTracking=True, fusedOneStep=True,
    )


def server_matcher(dev, matcher: str):
    if matcher == "loftr":
        return LoftrFeatureMatcher(threshold=LOFTR_THRESHOLD, fine=False, device=dev)
    return OrbFeatureMatcher(threshold=RATIO, max_features=2000, device=dev)


@contextlib.contextmanager
def sync_free_server_dispatch(server):
    """Run every SlamServer._prepare_and_dispatch of `server` under
    torch.cuda.set_sync_debug_mode("error"); counts the calls checked."""
    real = server._prepare_and_dispatch
    checked = {"dispatches": 0}

    def dispatch(images):
        torch.cuda.set_sync_debug_mode("error")
        try:
            real(images)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        checked["dispatches"] += 1

    server._prepare_and_dispatch = dispatch
    try:
        yield checked
    finally:
        server._prepare_and_dispatch = real


def stream_ate(system: System, traj) -> tuple:
    """(ATE of a System's per-frame trajectory against ground truth, frames)."""
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/t.txt"
        system.save_trajectory_tum(path)
        t, p, _ = trajectory.read_tum(path)
    gt_t = np.arange(len(traj)) * 0.1
    gt_p = np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in traj])
    return trajectory.ate_rmse(t, p, gt_t, gt_p)


def run_server(dev, world, trajs, frames, matcher: str, pipelined: bool, n_timed: int) -> dict:
    """bench_server's drive through the port's SlamServer: SERVER_WARM warm
    ticks, then n_timed timed ticks (host wall per tick; the pipelined
    drive's timed window ends after flush and a synchronization). Returns
    the record and the server."""
    reset_frame_ids()
    reset_map_ids()
    server = SlamServer(server_params(world, matcher), lambda: server_matcher(dev, matcher),
                        len(frames), device=dev)
    for system in server.systems:
        system.toggle_initialization_allowed()
    tick = server.step_pipelined if pipelined else server.step
    cuda = dev.type == "cuda"
    checker = sync_free_server_dispatch(server) if pipelined and cuda else \
        contextlib.nullcontext({"dispatches": None})
    n = SERVER_WARM + n_timed
    _reset_launches()
    with checker as checked:
        for i in range(SERVER_WARM):
            tick([f[i] for f in frames], timestamps=i * 0.1)
        for k in list(server.stats):
            if k.endswith("_samples_ms"):
                server.stats[k] = []
        before = dict(server.stats)
        tick_ms = []
        t0 = time.perf_counter()
        for i in range(SERVER_WARM, n):
            f0 = time.perf_counter()
            tick([f[i] for f in frames], timestamps=i * 0.1)
            tick_ms.append((time.perf_counter() - f0) * 1e3)
        if pipelined:
            server.flush()
        if cuda:
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    st = server.stats
    served = st["frames"] - before["frames"]
    batched = st["batched_frames"] - before["batched_frames"]
    hits = sum(fused_host.pipe_stats(s.tracker).get("hit", 0) for s in server.systems)
    stages = ("prepare", "dispatch", "readback", "track")
    per_tick = {k: sum(st.get(f"{k}_samples_ms", [])) / n_timed for k in stages}
    # a stage's p50 over its calls (readback: one per batched group)
    p50 = {k: _pct(st.get(f"{k}_samples_ms", []), 50) for k in stages}
    rec = {
        "matcher": matcher, "streams": len(frames), "size": [world.h, world.w],
        "warm_ticks": SERVER_WARM, "timed_ticks": n_timed, "pipelined": pipelined,
        "aggregate_fps": served / wall, "tick_p50_ms": _pct(tick_ms, 50),
        "tick_p95_ms": _pct(tick_ms, 95), "batched_share": batched / max(served, 1),
        "ms_per_tick": per_tick, "stage_p50_ms": p50,
        "stats": {k: v for k, v in st.items() if not k.endswith("_samples_ms")},
        "hits": hits, "launches": _serving_launches(),
        "states": [s.tracker.state.name for s in server.systems],
        "ate": [stream_ate(s, traj)[0] for s, traj in zip(server.systems, trajs)],
        "sync_free_dispatches": checked["dispatches"],
    }
    return rec, server


def independent_systems(dev, world, frames, matcher: str) -> list:
    """The server's streams run as independent port Systems (fused flow,
    the server's parameters and matcher, rng_seed s) on the same frames."""
    systems = []
    for s, fr in enumerate(frames):
        reset_frame_ids()
        reset_map_ids()
        m = server_matcher(dev, matcher)
        system = System(server_params(world, matcher), m, KeyFrameMatchDatabase(m),
                        verbose=False, rng_seed=s, device=dev)
        system.toggle_initialization_allowed()
        for i, img in enumerate(fr):
            system.track_monocular(img, timestamp=i * 0.1)
        systems.append(system)
    return systems


def check_server_run(rec: dict, server, refs: list, trajs) -> None:
    """tests/test_server.py's bounds: every stream OK, ATE < 0.15 against
    ground truth (LoFTR: < 0.2), trajectory pair < 0.05 against the
    independent System (LoFTR: MAX_LOFTR_PAIR_ATE); batched dispatches served
    and every one consumed. Prints the record."""
    loftr = rec["matcher"] == "loftr"
    max_ate = MAX_SERVER_LOFTR_ATE if loftr else MAX_SERVER_ATE
    max_pair = MAX_LOFTR_PAIR_ATE if loftr else MAX_SERVER_PAIR_ATE
    pairs = [trajectory_pair(s, r) for s, r in zip(server.systems, refs)]
    rec["pair_ate_vs_independent"] = [p for p, _ in pairs]
    rec["pair_frames"] = [k for _, k in pairs]
    rec["independent_ate"] = [stream_ate(r, t)[0] for r, t in zip(refs, trajs)]
    _print(rec)
    if any(st != "OK" for st in rec["states"]):
        raise AssertionError(f"server streams not OK: {rec['states']}")
    if not all(a < max_ate for a in rec["ate"]):
        raise AssertionError(f"server stream ATE {rec['ate']}")
    if not all(p < max_pair and k >= 8 for p, k in pairs):
        raise AssertionError(f"server streams vs independent Systems: {pairs}")
    if rec["stats"]["batch_groups"] < 3 or rec["hits"] < rec["stats"]["batched_frames"]:
        raise AssertionError(f"batched dispatch: {rec['stats']}, hits {rec['hits']}")
    groups, launches = rec["stats"]["batch_groups"], rec["launches"]
    # one B1 launch per ORB group (none for LoFTR), two B2 launches per group
    # beside the streams' own launches
    b1_want = 0 if loftr else groups
    if launches["b1_batch"] != b1_want or launches["b2"] < 2 * groups:
        raise AssertionError(f"server launches {launches} for {groups} batched groups")


def server_phases(dev) -> dict:
    """Phases server, server_pipelined and server_loftr (see the module
    docstring). Returns their launches."""
    world, trajs, frames = render_server(SERVER_STREAMS, SERVER_WARM + SERVER_TIMED)
    launches = collections.Counter()
    refs = independent_systems(dev, world, frames, "orb")
    for phase, pipelined in (("server", False), ("server_pipelined", True)):
        rec, server = run_server(dev, world, trajs, frames, "orb", pipelined, SERVER_TIMED)
        check_server_run({"phase": phase, "card": card(dev), **rec}, server, refs, trajs)
        if pipelined and rec["sync_free_dispatches"] < 1:
            raise AssertionError("no server dispatch ran under the sync debug mode")
        launches.update(rec["launches"])
    world, trajs_l, frames_l = render_server(SERVER_STREAMS, SERVER_WARM + SERVER_LOFTR_TIMED,
                                            SERVER_LOFTR_STEP)
    refs = independent_systems(dev, world, frames_l, "loftr")
    rec, server = run_server(dev, world, trajs_l, frames_l, "loftr", False, SERVER_LOFTR_TIMED)
    # bench_server's widest LoFTR step, as one System: recorded, not held
    wide = sim.lateral_trajectory(SERVER_WARM + SERVER_LOFTR_TIMED,
                                  step=0.02 + 0.004 * (SERVER_STREAMS - 1))
    sys_w = independent_systems(dev, world, [[world.render(T) for T in wide]], "loftr")[0]
    rec["bench_widest_step"] = {"step": 0.02 + 0.004 * (SERVER_STREAMS - 1),
                                "final_state": sys_w.tracker.state.name,
                                "keyframes": sys_w.map.n_keyframes()}
    check_server_run({"phase": "server_loftr", "card": card(dev), **rec}, server, refs, trajs_l)
    launches.update(rec["launches"])
    return dict(launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _print({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    _kernels.load()
    ptxas = {_kernel_name(k): v for k, v in _kernels.ptxas_report(_kernels.build_info.log).items()}
    _print({"phase": "build", "seconds": round(_kernels.build_info.seconds, 3),
            "built": _kernels.build_info.built, "library": str(_kernels.build_info.path),
            "ptxas": ptxas})
    check_ptxas(ptxas)

    cfg = FULL
    t0 = time.perf_counter()
    world, poses, images = render(cfg)  # rendered once, before any timing
    _print({"phase": "render", "frames": len(images),
            "seconds": round(time.perf_counter() - t0, 3)})

    b1 = check_b1(images[0], dev)
    _print(b1)
    b2 = check_b2(dev)
    _print(b2)
    _print(check_extract(images[0], dev, cfg.max_features))
    _print(check_hamming(dev))

    # ---- the slice: chained steady steps through both kernels ----
    seed = seed_map(dev, cfg, world, poses, images)
    gt = np.stack(poses[cfg.n_kf:])
    _reset_launches()
    run = drive(dev, cfg, seed, poses, images)
    n_b1 = detect.detect_maps_cuda.launches
    n_b2 = pose_opt_cuda.pose_lm_batched.launches
    if n_b1 != cfg.n_frames or n_b2 != 2 * cfg.n_frames:
        raise AssertionError(f"launches B1 {n_b1}, B2 {n_b2} over {cfg.n_frames} frames")
    c_err, r_err = pose_errors(run.T2, gt)
    with plain_kernels():
        plain = drive(dev, cfg, seed, poses, images)
    pose_diff = float(np.abs(run.T2 - plain.T2).max())
    steady = run.frame_ms[3:]
    _print({
        "phase": "slice", "frames": cfg.n_frames, "size": [cfg.h, cfg.w],
        "max_features": cfg.max_features, "local_keyframes": cfg.n_kf, "cap": cfg.cap,
        "launches_b1": n_b1, "launches_b2": n_b2,
        "max_center_err_m": float(c_err.max()), "max_rot_err_deg": float(r_err.max()),
        "min_n_good2": int(run.n_good2.min()),
        "ms_per_frame_median": float(np.median(steady)),
        "ms_per_frame_p90": float(np.percentile(steady, 90)),
        "plain_ms_per_frame_median": float(np.median(plain.frame_ms[3:])),
        "plain_pose_max_abs_diff": pose_diff,
    })
    if c_err.max() > MAX_CENTER_ERR or r_err.max() > MAX_ROT_ERR_DEG:
        raise AssertionError(f"pose error centre {c_err.max()} m, rotation {r_err.max()} deg")
    if run.n_good2.min() < MIN_N_GOOD2:
        raise AssertionError(f"second-LM n_good fell to {run.n_good2.min()}")
    if not pose_diff <= 1e-3:
        raise AssertionError(f"kernel and plain drives differ by {pose_diff}")

    # ---- each kernel alone against its plain version, main-path shapes ----
    dims = orb._level_dims(cfg.h, cfg.w)
    stack = orb.pyramid(torch.from_numpy(images[cfg.n_kf]).to(dev))
    b1_ms = _per_launch_ms(b1_bare(stack, dims))
    b1_wrapper_ms = _per_launch_ms(
        lambda: detect.detect_maps_cuda(stack, dims, FAST_THRESHOLD, orb.BORDER))
    b1_plain_ms = _cuda_ms(
        lambda: detect.detect_maps_plain(stack, dims, FAST_THRESHOLD, orb.BORDER))
    args = [torch.from_numpy(a).to(dev) for a in pose_problem()]
    b2_ms = _per_launch_ms(b2_bare(*args))
    b2_wrapper_ms = _per_launch_ms(lambda: pose_opt_cuda.pose_optimize_cuda(*args))
    b2_plain_ms = _cuda_ms(lambda: pose_opt.pose_optimize_plain(*args))
    st_args = [torch.from_numpy(a).to(dev) for a in steady_problem()]
    b2_steady_ms = _per_launch_ms(b2_bare(*st_args))
    b2_steady_wrapper_ms = _per_launch_ms(lambda: pose_opt_cuda.pose_optimize_cuda(*st_args))
    _print({"phase": "kernel_times", "launches_per_run": 200, "runs": 5,
            "b1_ms": b1_ms, "b1_wrapper_ms": b1_wrapper_ms, "b1_plain_ms": b1_plain_ms,
            "b2_ms": b2_ms, "b2_wrapper_ms": b2_wrapper_ms, "b2_plain_ms": b2_plain_ms,
            "b2_steady_slots": len(st_args[1]),
            "b2_steady_valid_share": float(st_args[3].float().mean()),
            "b2_steady_ms": b2_steady_ms, "b2_steady_wrapper_ms": b2_steady_wrapper_ms})
    _print(b2_cluster_sweep(dev))

    # ---- the per-level detection path: B1-banded and B1-full ----
    small = render(SMALL._replace(n_frames=1))[2][0]  # a 240x320 view
    lvl_full = check_b1_per_level(images[0], dev)
    lvl_small = check_b1_per_level(small, dev)
    n_feat = [check_extract_per_level(images[0], dev, cfg.max_features),
              check_extract_per_level(small, dev, SMALL.max_features)]
    views = [(images[i], cfg.max_features) for i in range(cfg.n_kf, cfg.n_kf + cfg.n_frames)]
    views.append((small, SMALL.max_features))
    detect.detect_level_cuda.launches = {"banded": 0, "full": 0}
    for img, k in views:
        orb.extract(torch.from_numpy(img).to(dev), k, FAST_THRESHOLD, per_level=True)
    torch.cuda.synchronize(dev)
    per_level_launches = dict(detect.detect_level_cuda.launches)
    want = {"banded": 8 * cfg.n_frames + 5, "full": 3}
    if per_level_launches != want:
        raise AssertionError(f"per-level launches {per_level_launches}, expected {want}")

    def levels_of(img):
        dims = orb._level_dims(*img.shape)
        row0, _, _ = detect.level_layout(dims)
        st = orb.pyramid(torch.from_numpy(img).to(dev))
        return [st[r: r + h, :w].contiguous() for (h, w), r in zip(dims, row0)]

    def run_levels(fn, levels):
        return lambda: [fn(lv, FAST_THRESHOLD, orb.BORDER) for lv in levels]

    def bare_levels(levels):
        fns = [b1_bare(lv, (tuple(lv.shape),)) for lv in levels]
        return lambda: [f() for f in fns]

    banded_levels = levels_of(images[cfg.n_kf])  # all 8 levels of 640x480: > 96 rows
    full_levels = [lv for lv in levels_of(small) if lv.shape[0] <= detect.FULL_MAX_ROWS]
    banded_ms = _per_launch_ms(bare_levels(banded_levels))
    banded_wrapper_ms = _per_launch_ms(run_levels(detect.detect_level_cuda, banded_levels))
    banded_plain_ms = _cuda_ms(run_levels(detect.level_maps_plain, banded_levels))
    full_ms = _per_launch_ms(bare_levels(full_levels))
    full_wrapper_ms = _per_launch_ms(run_levels(detect.detect_level_cuda, full_levels))
    full_plain_ms = _cuda_ms(run_levels(detect.level_maps_plain, full_levels))
    banded_dims = [tuple(lv.shape) for lv in banded_levels]
    full_dims = [tuple(lv.shape) for lv in full_levels]
    _print({"phase": "b1_per_level", "views": [lvl_full, lvl_small],
            "extract_equal_keypoints": n_feat, "launches": per_level_launches,
            "one_level_launches_640x480_ms": banded_ms,
            "one_level_launches_640x480_wrapper_ms": banded_wrapper_ms,
            "one_launch_640x480_ms": b1_ms,
            "one_level_launches_640x480_plain_ms": banded_plain_ms,
            "full_levels_240x320": [list(d) for d in full_dims],
            "full_levels_ms": full_ms, "full_levels_wrapper_ms": full_wrapper_ms,
            "full_levels_plain_ms": full_plain_ms})

    # ---- the System: initialization, tracking, local mapping with BA ----
    sys_cfg = SYSTEM_FULL
    world_s, poses_s, images_s = render_system(sys_cfg)  # before any timing
    run = run_system(dev, sys_cfg, world_s, poses_s, images_s)
    with plain_kernels():
        plain_run = run_system(dev, sys_cfg, world_s, poses_s, images_s)
    both = ~np.isnan(run["Tcw"][:, 0, 0]) & ~np.isnan(plain_run["Tcw"][:, 0, 0])
    pose_diff = np.abs(run["Tcw"][both] - plain_run["Tcw"][both]).max(axis=(1, 2))
    rec = {"phase": "system", **system_record(run),
           "plain": system_record(plain_run),
           "plain_pose_max_abs_diff_per_frame": pose_diff.tolist()}
    _print(rec)
    check_system_run(run, kernels=True)
    check_system_run(plain_run, kernels=False)

    fused_launches = fused_phases(dev, sys_cfg, SYSTEM_KF, world_s, poses_s, images_s, run)
    loop_launches = reloc_loop_phase(dev, LOOP_FULL)

    # ---- the LoFTR matcher: model, System in three flows, B2 at 1200 slots ----
    _print(check_loftr_model(dev))
    loftr = loftr_system_phases(dev)
    quality = run_quality_loftr(dev)
    _print(quality)
    check_quality_loftr(quality)
    loftr_launches = {k: loftr["launches"][k] + quality["launches"][k] for k in ("b1", "b2")}
    b2_loftr = loftr["b2"]

    # ---- the application layer: native runtime, CLI, apps, graph cost ----
    _print(native_phase(dev))
    app_launches = collections.Counter(cli_phases(dev, sys_cfg, world_s, poses_s, images_s))
    app_launches.update(interactive_phase(dev, sys_cfg, world_s, images_s))
    app_launches.update(quality_bench_phase(dev))
    app_launches.update(kf_graph_phase(dev, SYSTEM_KF))

    # ---- multi-stream serving: the batched steady step and SlamServer ----
    b1_batch = check_b1_batch(np.stack(images[:4]), dev)
    _print(b1_batch)
    b2_batch = check_b2_batch(dev, MULTI_STREAMS)
    _print(b2_batch)
    multi = multistream_phase(dev)
    serve_launches = server_phases(dev)
    batch_b1 = multi["launches"]["b1_batch"] + serve_launches["b1_batch"]
    batch_b2 = multi["launches"]["b2"] + serve_launches["b2"]

    b1_stack_bound = b1_bound(dims, stacked=True)
    banded_bound = b1_bound(banded_dims, stacked=False)
    full_bound = b1_bound(full_dims, stacked=False)
    b2_prob = pose_problem()
    b2_b = b2_bound(len(b2_prob[1]), int(b2_prob[3].sum()))
    _print({"kernels": [
        {"name": "detect_maps", "route": "cuda",
         "source": "mono_slam_framework_torch/csrc/detect.cu",
         "replaces": "mono_slam_framework_tpu/ops/pallas_detect.py:306",
         "launches": n_b1 + run["launches"]["b1"] + fused_launches["b1"] + loop_launches["b1"]
         + loftr_launches["b1"] + app_launches["b1"] + serve_launches["b1"] + batch_b1,
         "max_abs_err": max(b1["max_abs_err"].values()),
         "ms": b1_ms, "wrapper_ms": b1_wrapper_ms, "plain_ms": b1_plain_ms,
         "bound_ms": b1_stack_bound[0],
         "bound_by": b1_stack_bound[1], "library_ms": None, "design": DESIGN,
         "app_launches": app_launches["b1"],
         "batch_launches": batch_b1, "multistream_batch_launches": multi["launches"]["b1_batch"],
         "server_batch_launches": serve_launches["b1_batch"],
         "server_one_stream_launches": serve_launches["b1"],
         "batch_streams_ms": multi["b1_batch_bare_ms"],
         "batch_streams_bound_ms": multi["b1_batch_bound_ms"],
         "batch_max_abs_err": max(b1_batch["max_abs_err"].values())},
        {"name": "detect_level (B1-banded: 8 one-level launches, 640x480)", "route": "cuda",
         "source": "mono_slam_framework_torch/csrc/detect.cu",
         "replaces": "mono_slam_framework_tpu/ops/pallas_detect.py:215",
         "launches": per_level_launches["banded"],
         "max_abs_err": max(lvl_full["max_abs_err"].values()),
         "ms": banded_ms, "wrapper_ms": banded_wrapper_ms, "plain_ms": banded_plain_ms,
         "bound_ms": banded_bound[0],
         "bound_by": banded_bound[1], "library_ms": None, "design": DESIGN},
        {"name": "detect_level (B1-full: levels 5-7, 240x320)", "route": "cuda",
         "source": "mono_slam_framework_torch/csrc/detect.cu",
         "replaces": "mono_slam_framework_tpu/ops/pallas_detect.py:202",
         "launches": per_level_launches["full"],
         "max_abs_err": max(lvl_small["max_abs_err"].values()),
         "ms": full_ms, "wrapper_ms": full_wrapper_ms, "plain_ms": full_plain_ms,
         "bound_ms": full_bound[0],
         "bound_by": full_bound[1], "library_ms": None, "design": DESIGN},
        {"name": "pose_lm", "route": "cuda",
         "source": "mono_slam_framework_torch/csrc/pose_lm.cu",
         "replaces": "mono_slam_framework_tpu/optim/pose_opt_pallas.py:203",
         "launches": n_b2 + run["launches"]["b2"] + fused_launches["b2"] + loop_launches["b2"]
         + loftr_launches["b2"] + app_launches["b2"] + batch_b2,
         "app_launches": app_launches["b2"],
         "multistream_launches": multi["launches"]["b2"], "server_launches": serve_launches["b2"],
         "batch_problems_ms": multi["b2_batch_bare_ms"],
         "batch_problems_bound_ms": multi["b2_batch_bound_ms"],
         "batch_max_abs_err": b2_batch["T_max_abs_err"],
         "max_abs_err": b2["edges_2000"]["T_max_abs_err"],
         "ms": b2_ms, "wrapper_ms": b2_wrapper_ms, "plain_ms": b2_plain_ms,
         "bound_ms": b2_b[0],
         "bound_by": b2_b[1], "library_ms": None, "design": DESIGN,
         "loftr_launches": loftr_launches["b2"],
         "loftr_slots": b2_loftr["slots"], "loftr_valid": b2_loftr["valid"],
         "loftr_max_abs_err": b2_loftr["T_max_abs_err"], "loftr_ms": b2_loftr["ms"],
         "loftr_wrapper_ms": b2_loftr["wrapper_ms"], "loftr_plain_ms": b2_loftr["plain_ms"],
         "loftr_bound_ms": b2_loftr["bound_ms"], "loftr_bound_by": b2_loftr["bound_by"]},
    ]})
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
