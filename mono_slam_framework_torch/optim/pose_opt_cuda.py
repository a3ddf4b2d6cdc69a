"""Kernel B2 wrapper: the 4x10 pose LM as one CUDA launch (`csrc/pose_lm.cu`).

Hopper counterpart of `mono_slam_framework_tpu/optim/pose_opt_pallas.py`.
`pose_optimize_cuda` has the arguments and returns of
`pose_opt.pose_optimize_plain`, `pose_lm_batched` those of
`pose_opt.pose_lm_batched_plain`; CUDA tensors only. The kernel writes every
output itself (the orthonormalized pose, the inlier mask ANDed with valid,
the inlier count), so a call is a check of what it is given, the outputs'
`torch.empty` and one launch on the current stream; it raises on a launch
error or a refused cluster launch, and never falls back.

`lm_plan` is the launch plan in plain Python (no card needed): a cluster of
`cluster` CTAs per problem, each owning a slice of `slice` edge slots (a
multiple of 16), the first `resident` of them staged in shared memory.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from mono_slam_framework_torch import _kernels

THREADS = 256  # per CTA
CLUSTERS = (1, 2, 4, 8)  # the cluster sizes the kernel is built for
CLUSTER = 8  # the fastest of CLUSTERS at 2000 edges on the H100 (PERF.md §6)
MAX_SMEM = 232_448  # 227 KB: the most shared memory a block may have
SLOT_BYTES = 62  # shared bytes per resident slot (csrc/pose_lm.cu::layout)


def smem_bytes(resident: int, cluster: int) -> int:
    """Dynamic shared memory of one CTA (csrc/pose_lm.cu::layout): a
    128-byte header, the warps' totals, two buffers of the cluster's CTA
    totals, the raw copies of the slots (16 B of alignment slack each) and
    the compacted edges with their slots, two chi2 buffers and inlier flags."""
    return 128 + (THREADS // 32) * 32 * 4 + 2 * cluster * 32 * 4 + 64 + SLOT_BYTES * resident


class LMPlan(NamedTuple):
    cluster: int  # CTAs per problem
    slice: int  # edge slots per CTA, a multiple of 16
    resident: int  # of those, staged in shared memory (the rest are read from device memory)
    smem: int  # dynamic shared bytes per CTA


@functools.lru_cache(maxsize=None)
def lm_plan(E: int, cluster: int = CLUSTER) -> LMPlan:
    """CTA r of a problem's cluster owns slots [r * slice, (r + 1) * slice)
    of its E, the first `resident` in shared memory."""
    if cluster not in CLUSTERS:
        raise ValueError(f"cluster size {cluster} is not one of {CLUSTERS}")
    if E < 0:
        raise ValueError(f"negative edge count {E}")
    per_cta = -(-E // cluster)
    slice_ = 16 * -(-per_cta // 16)
    cap = (MAX_SMEM - smem_bytes(0, cluster)) // SLOT_BYTES // 16 * 16
    resident = min(slice_, cap)
    return LMPlan(cluster, slice_, resident, smem_bytes(resident, cluster))


def _check(name, t, shape, dtype):
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def _launch(T_init, Xw, uv, valid, K, info, B, E, cluster):
    """Check, allocate the outputs and launch B2 over B problems whose
    tensors carry a leading axis of B (or none for B = 1)."""
    dev = Xw.device
    if dev.type != "cuda":
        raise ValueError(f"kernel B2 needs CUDA tensors, got {dev}")
    lead = (B,) if Xw.dim() == 3 else ()
    f32 = torch.float32
    _check("T_init", T_init, (*lead, 4, 4), f32)
    _check("Xw", Xw, (*lead, E, 3), f32)
    _check("uv", uv, (*lead, E, 2), f32)
    _check("valid", valid, (*lead, E), torch.bool)
    _check("K", K, (*lead, 3, 3), f32)
    if info is not None:
        _check("info", info, (*lead, E), f32)
        info = info.contiguous()
    T_init, Xw, uv, valid, K = (t.contiguous() for t in (T_init, Xw, uv, valid, K))
    for t in (T_init, uv, valid, K) + (() if info is None else (info,)):
        if t.device != dev:
            raise ValueError(f"kernel B2 needs every tensor on {dev}, got {t.device}")
    plan = lm_plan(E, cluster)
    T_out = torch.empty((*lead, 4, 4), dtype=f32, device=dev)
    inlier = torch.empty((*lead, E), dtype=torch.bool, device=dev)
    n_good = torch.empty(lead, dtype=torch.int32, device=dev)
    err = _kernels.load().pose_lm_launch(
        Xw.data_ptr(), uv.data_ptr(), valid.data_ptr(),
        None if info is None else info.data_ptr(), K.data_ptr(), T_init.data_ptr(),
        T_out.data_ptr(), inlier.data_ptr(), n_good.data_ptr(), B, E,
        plan.cluster, plan.slice, plan.resident, plan.smem, _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "pose_lm_launch")
    pose_lm_batched.launches += 1
    return T_out, inlier, n_good


def pose_lm_batched(T_init, Xw, uv, valid, K, info=None, cluster: int = CLUSTER):
    """Launch kernel B2 over B problems.

    T_init [B,4,4], Xw [B,E,3], uv [B,E,2], K [B,3,3], info [B,E] or None
    (ones) f32; valid [B,E] bool; all on one CUDA device. Returns (T [B,4,4]
    with its rotation orthonormalized, inlier bool [B,E] ANDed with valid,
    n_good int32 [B]).
    """
    B, E = Xw.shape[0], Xw.shape[1]
    return _launch(T_init, Xw, uv, valid, K, info, B, E, cluster)


pose_lm_batched.launches = 0


def pose_optimize_cuda(T_init, Xw, uv, valid, K, info=None):
    """Kernel-backed twin of `pose_opt.pose_optimize_plain` for one problem:
    (T [4,4], inlier bool [E], n_good int32 [])."""
    return _launch(T_init, Xw, uv, valid, K, info, 1, Xw.shape[0], CLUSTER)
