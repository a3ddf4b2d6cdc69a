#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port's main path.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and this
checkout; it exits non-zero without either. Each phase prints one JSON
line and raises if it fails:

  1. device   — nvidia-smi name / power limit, torch and CUDA versions;
  2. build    — nvcc builds csrc/*.cu into the kernel library;
  3. b1       — kernel B1 (detection maps) against its plain version on a
                rendered 640x480 view, per level on interior pixels;
  4. b2       — kernel B2 (pose LM) against its plain version on a seeded
                pose problem with 2000 edges, outliers, padding and info;
  5. extract  — orb.extract through B1 against the plain path, by feature set;
  6. slice    — 40 chained frames of fused_tracking.steady_step at 640x480,
                2000 features, 8 local keyframes and tables of 1024, on a map
                seeded from the simulator's geometry; checks launch counts,
                poses against ground truth and against the same drive with
                both kernels replaced by their plain versions, and times it;
  7. kernel_times — B1 and B2 alone against their plain versions;
  8. b1_per_level — the one-level launches of B1 (the Hopper form of the
                JAX package's per-level B1-banded / B1-full kernels) against
                level_maps_plain at every level of a 640x480 and a 240x320
                view, orb.extract(per_level=True) against the one-launch
                extract feature for feature, and the per-level path's launch
                counts and times;
  9. system   — System.track_monocular (two-view initialization, tracking,
                local mapping with BA, loop detection) over 42 frames at
                640x480 and 2000 features, 12 warm then 30 timed: frames/s,
                latency, stage split, launches, ATE; then the same drive with
                both kernels replaced by their plain versions.

The last three lines are the kernels' JSON summary, the card's name and
power limit, and {"ok": true, "device": {...}}.

The world seeding (`seed_map`), the drives (`drive`, `run_system`) and the
checks take a device and a size, so the CPU tests run them at a small size.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import subprocess
import sys
import time
from typing import NamedTuple
from unittest import mock

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from mono_slam_framework_torch import _kernels, convert, sim  # noqa: E402
from mono_slam_framework_torch.geometry import se3  # noqa: E402
from mono_slam_framework_torch.io import trajectory  # noqa: E402
from mono_slam_framework_torch.matchers import OrbFeatureMatcher  # noqa: E402
from mono_slam_framework_torch.ops import detect, orb  # noqa: E402
from mono_slam_framework_torch.optim import pose_opt, pose_opt_cuda  # noqa: E402
from mono_slam_framework_torch.params import SlamParameters  # noqa: E402
from mono_slam_framework_torch.slam import KeyFrameMatchDatabase, System  # noqa: E402
from mono_slam_framework_torch.slam import fused_tracking  # noqa: E402
from mono_slam_framework_torch.slam.frame import reset_frame_ids  # noqa: E402
from mono_slam_framework_torch.slam.map_model import reset_map_ids  # noqa: E402

RATIO = 0.7
FAST_THRESHOLD = 20.0


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
    comparison drive on the card)."""
    with mock.patch.object(detect, "detect_maps", detect.detect_maps_plain), \
            mock.patch.object(pose_opt, "pose_optimize", pose_opt.pose_optimize_plain):
        yield


def pose_problem(seed: int = 0, n: int = 2000, n_outliers: int = 100,
                 n_pad: int = 64):
    """A seeded motion-only pose problem (test_optim.make_pose_problem's
    construction) with outliers, padded edges and per-edge info; numpy."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4, 10, n)], -1)
    exp = lambda xi: se3.exp_se3(torch.from_numpy(xi)).numpy()  # noqa: E731
    xi_true = rng.normal(size=6) * 0.1
    T_true = exp(xi_true)
    Xc = X @ T_true[:3, :3].T + T_true[:3, 3]
    uv = (Xc[:, :2] / Xc[:, 2:]) * 500 + [320, 240]
    uv = uv + rng.normal(0, 0.8, uv.shape)
    idx = rng.choice(n - n_pad, n_outliers, replace=False)
    uv[idx] += rng.uniform(30, 120, (n_outliers, 2)) * rng.choice([-1, 1], (n_outliers, 2))
    T0 = exp(xi_true + rng.normal(size=6) * 0.05)
    valid = np.ones(n, bool)
    valid[n - n_pad:] = False
    X[~valid] = 0.0
    uv[~valid] = 0.0
    info = rng.uniform(0.5, 1.5, n)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return f32(T0), f32(X), f32(uv), valid, f32(K), f32(info)


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
    rec = {"phase": "b1", "score_flips": flips, "interior_px": n_interior,
           "max_abs_err": max_err}
    if failures or flips > 0.001 * n_interior:
        raise AssertionError(f"B1 differs from its plain version: {failures} {rec}")
    return rec


def check_b2(device):
    """Kernel B2 against pose_optimize_plain on the card, at 2000 edges, with
    the tolerances of tests/test_optim.py's Pallas-vs-XLA check."""
    T0, X, uv, valid, K, info = pose_problem()
    args = [torch.from_numpy(a).to(device) for a in (T0, X, uv, valid, K, info)]
    T_k, in_k, ng_k = pose_opt_cuda.pose_optimize_cuda(*args)
    T_p, in_p, ng_p = pose_opt.pose_optimize_plain(*args)
    T_k, T_p = T_k.cpu().numpy(), T_p.cpu().numpy()
    agree = float((in_k == in_p).float().mean())
    err = float(np.abs(T_k - T_p).max())
    np.testing.assert_allclose(T_k, T_p, atol=1e-4)
    if not agree > 0.98:
        raise AssertionError(f"B2 inlier agreement {agree}")
    if abs(int(ng_k) - int(ng_p)) > 2:
        raise AssertionError(f"B2 n_good {int(ng_k)} vs plain {int(ng_p)}")
    return {"phase": "b2", "edges": len(X), "T_max_abs_err": err,
            "inlier_agreement": agree, "n_good": int(ng_k), "n_good_plain": int(ng_p)}


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
# 84, J^T W r 24; and the passes: 4 rounds x (1 + 10 trial) + 4
# reclassifications.
B2_OPS_PER_EDGE_PASS = 15 + 8 + 6 + 4 + 36 + 84 + 24
B2_EDGE_PASSES = 4 * 11 + 4
# H100 SXM data sheet, at the card's full 700 W limit
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(n_bytes: float, n_ops: float):
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the f32 operations over the peak rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def b1_bound(dims, stacked: bool):
    """B1's bound over levels `dims`: one stacked launch reads the
    [rows, w0] stack and writes 5 maps of it; one-level launches read and
    write each level at its own size. Operations count real pixels."""
    px = sum(h * w for h, w in dims)
    _, rows, w0 = detect.level_layout(tuple(dims))
    n_bytes = 4 * 6 * (rows * w0 if stacked else px)
    return bound_ms(n_bytes, B1_OPS_PER_PIXEL * px)


def b2_bound(n_edges: int):
    """B2's bound for one problem of n_edges: inputs Xw, uv, valid, info
    (7 f32 per edge), T and K; outputs T and one inlier flag per edge."""
    n_bytes = 4 * (7 * n_edges + 16 + 4) + 4 * (16 + n_edges)
    return bound_ms(n_bytes, B2_OPS_PER_EDGE_PASS * B2_EDGE_PASSES * n_edges)


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


def render_system(cfg: SystemConfig):
    """(world, ground-truth poses, images) of the system drive, rendered
    before any timing."""
    world = sim.PlaneWorld(width=cfg.w, height=cfg.h, f=cfg.f, second_plane=(3.0, 0.3))
    poses = sim.lateral_trajectory(cfg.n_warm + cfg.n_timed, step=cfg.step)
    return world, poses, [world.render(T) for T in poses]


def build_system(device, cfg: SystemConfig, world) -> System:
    """bench.py's reference-twin System (fusedTracking=False) on `device`."""
    reset_frame_ids()
    reset_map_ids()
    params = SlamParameters(
        fx=world.f, fy=world.f, cx=world.cx, cy=world.cy,
        max_features=cfg.max_features, minIniMatchCount=100,
        initializerModelFallback=True, fusedTracking=False,
    )
    matcher = OrbFeatureMatcher(threshold=RATIO, max_features=cfg.max_features,
                                device=device)
    return System(params, matcher, KeyFrameMatchDatabase(matcher), verbose=False,
                  device=device)


def _pct(xs, q):
    return float(np.percentile(xs, q)) if len(xs) else None


def run_system(device, cfg: SystemConfig, world, poses, images, system=None) -> dict:
    """Drive System.track_monocular over every image (gate toggled), timing
    the frames after cfg.n_warm (synchronized on a card). Returns the
    drive's record: states, live poses, latency, stage split, launches, ATE."""
    system = system or build_system(device, cfg, world)
    system.toggle_initialization_allowed()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda *_: None)
    detect.detect_maps_cuda.launches = 0
    pose_opt_cuda.pose_lm_batched.launches = 0
    states, Tcw, frame_ms, kf_event_ms = [], [], [], []
    n_kf_before = 0
    t_timed = 0.0
    for i, img in enumerate(images):
        if i == cfg.n_warm:
            system.timer.reset()
            n_kf_before = system.map.n_keyframes()
        t0 = time.perf_counter()
        system.track_monocular(img, timestamp=i * 0.1)
        sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        states.append(system.tracker.state.name)
        T = system.tracker.current_frame.get_pose()
        Tcw.append(np.full((4, 4), np.nan, np.float32) if T is None else T)
        if i >= cfg.n_warm:
            t_timed += ms
            frame_ms.append(ms)
            n_kf = system.map.n_keyframes()
            if n_kf != n_kf_before:
                kf_event_ms.append(ms)
                n_kf_before = n_kf
    launches = {"b1": detect.detect_maps_cuda.launches,
                "b2": pose_opt_cuda.pose_lm_batched.launches}

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
    return {
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
        "kf_events": len(kf_event_ms), "kf_event_p95_ms": _pct(kf_event_ms, 95),
        "stage_ms_per_frame": {k: 1e3 * v / max(n_timed, 1)
                               for k, v in system.timer.totals.items()},
        "launches": launches,
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
    """run_system's record without the objects, for printing."""
    return {k: v for k, v in run.items() if k not in ("Tcw", "system", "states")}


def _print(rec):
    print(json.dumps(rec), flush=True)


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

    lib = _kernels.load()
    _print({"phase": "build", "seconds": round(_kernels.build_info.seconds, 3),
            "built": _kernels.build_info.built, "library": str(_kernels.build_info.path),
            "ptxas": [ln for ln in _kernels.build_info.log.splitlines() if "registers" in ln]})
    del lib

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

    # ---- the slice: chained steady steps through both kernels ----
    seed = seed_map(dev, cfg, world, poses, images)
    gt = np.stack(poses[cfg.n_kf:])
    detect.detect_maps_cuda.launches = 0
    pose_opt_cuda.pose_lm_batched.launches = 0
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
    b1_ms = _cuda_ms(lambda: detect.detect_maps_cuda(stack, dims, FAST_THRESHOLD, orb.BORDER))
    b1_plain_ms = _cuda_ms(
        lambda: detect.detect_maps_plain(stack, dims, FAST_THRESHOLD, orb.BORDER))
    args = [torch.from_numpy(a).to(dev) for a in pose_problem()]
    b2_ms = _cuda_ms(lambda: pose_opt_cuda.pose_optimize_cuda(*args))
    b2_plain_ms = _cuda_ms(lambda: pose_opt.pose_optimize_plain(*args))
    _print({"phase": "kernel_times", "runs": 20, "b1_ms": b1_ms, "b1_plain_ms": b1_plain_ms,
            "b2_ms": b2_ms, "b2_plain_ms": b2_plain_ms})

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

    banded_levels = levels_of(images[cfg.n_kf])  # all 8 levels of 640x480: > 96 rows
    full_levels = [lv for lv in levels_of(small) if lv.shape[0] <= detect.FULL_MAX_ROWS]
    banded_ms = _cuda_ms(run_levels(detect.detect_level_cuda, banded_levels))
    banded_plain_ms = _cuda_ms(run_levels(detect.level_maps_plain, banded_levels))
    full_ms = _cuda_ms(run_levels(detect.detect_level_cuda, full_levels))
    full_plain_ms = _cuda_ms(run_levels(detect.level_maps_plain, full_levels))
    banded_dims = [tuple(lv.shape) for lv in banded_levels]
    full_dims = [tuple(lv.shape) for lv in full_levels]
    _print({"phase": "b1_per_level", "views": [lvl_full, lvl_small],
            "extract_equal_keypoints": n_feat, "launches": per_level_launches,
            "runs": 20, "one_level_launches_640x480_ms": banded_ms,
            "one_launch_640x480_ms": b1_ms,
            "one_level_launches_640x480_plain_ms": banded_plain_ms,
            "full_levels_240x320": [list(d) for d in full_dims],
            "full_levels_ms": full_ms, "full_levels_plain_ms": full_plain_ms})

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

    b1_stack_bound = b1_bound(dims, stacked=True)
    banded_bound = b1_bound(banded_dims, stacked=False)
    full_bound = b1_bound(full_dims, stacked=False)
    b2_b = b2_bound(len(pose_problem()[1]))
    _print({"kernels": [
        {"name": "detect_maps", "route": "cuda",
         "source": "mono_slam_framework_torch/csrc/detect.cu",
         "replaces": "mono_slam_framework_tpu/ops/pallas_detect.py:306",
         "launches": n_b1 + run["launches"]["b1"],
         "max_abs_err": max(b1["max_abs_err"].values()),
         "ms": b1_ms, "plain_ms": b1_plain_ms, "bound_ms": b1_stack_bound[0],
         "bound_by": b1_stack_bound[1], "library_ms": None},
        {"name": "detect_level (B1-banded: 8 one-level launches, 640x480)", "route": "cuda",
         "source": "mono_slam_framework_torch/csrc/detect.cu",
         "replaces": "mono_slam_framework_tpu/ops/pallas_detect.py:215",
         "launches": per_level_launches["banded"],
         "max_abs_err": max(lvl_full["max_abs_err"].values()),
         "ms": banded_ms, "plain_ms": banded_plain_ms, "bound_ms": banded_bound[0],
         "bound_by": banded_bound[1], "library_ms": None},
        {"name": "detect_level (B1-full: levels 5-7, 240x320)", "route": "cuda",
         "source": "mono_slam_framework_torch/csrc/detect.cu",
         "replaces": "mono_slam_framework_tpu/ops/pallas_detect.py:202",
         "launches": per_level_launches["full"],
         "max_abs_err": max(lvl_small["max_abs_err"].values()),
         "ms": full_ms, "plain_ms": full_plain_ms, "bound_ms": full_bound[0],
         "bound_by": full_bound[1], "library_ms": None},
        {"name": "pose_lm", "route": "cuda",
         "source": "mono_slam_framework_torch/csrc/pose_lm.cu",
         "replaces": "mono_slam_framework_tpu/optim/pose_opt_pallas.py:203",
         "launches": n_b2 + run["launches"]["b2"], "max_abs_err": b2["T_max_abs_err"],
         "ms": b2_ms, "plain_ms": b2_plain_ms, "bound_ms": b2_b[0],
         "bound_by": b2_b[1], "library_ms": None},
    ]})
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
