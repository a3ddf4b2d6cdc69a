"""Kernel B2 wrapper: the 4x10 pose LM as one CUDA launch (`csrc/pose_lm.cu`).

Hopper counterpart of `mono_slam_framework_tpu/optim/pose_opt_pallas.py`.
Same arguments and returns as `pose_opt.pose_optimize_plain`; CUDA f32
tensors only. The wrapper checks what it is given, allocates the outputs,
launches on the current stream and raises on a launch error. Like the JAX
wrapper, it orthonormalizes the returned rotation in plain torch.
"""

from __future__ import annotations

import torch

from mono_slam_framework_torch import _kernels
from mono_slam_framework_torch.geometry import se3


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def pose_lm_batched(T_init, Xw, uv, valid, info, k4):
    """Launch kernel B2 over B problems.

    T_init [B,4,4], Xw [B,E,3], uv [B,E,2], valid [B,E] (0/1), info [B,E],
    k4 [B,4] = (fx, fy, cx, cy), all f32 contiguous CUDA tensors.
    Returns (T [B,4,4] not orthonormalized, inlier f32 [B,E] of 0/1 before
    masking by valid).
    """
    dev = T_init.device
    if dev.type != "cuda":
        raise ValueError(f"pose_lm_batched needs CUDA tensors, got {dev}")
    B, E = Xw.shape[0], Xw.shape[1]
    f32 = torch.float32
    _check("T_init", T_init, (B, 4, 4), f32, dev)
    _check("Xw", Xw, (B, E, 3), f32, dev)
    _check("uv", uv, (B, E, 2), f32, dev)
    _check("valid", valid, (B, E), f32, dev)
    _check("info", info, (B, E), f32, dev)
    _check("k4", k4, (B, 4), f32, dev)
    lib = _kernels.load()
    T_out = torch.empty((B, 4, 4), dtype=f32, device=dev)
    inlier = torch.empty((B, E), dtype=f32, device=dev)
    err = lib.pose_lm_launch(
        Xw.data_ptr(), uv.data_ptr(), valid.data_ptr(), info.data_ptr(),
        k4.data_ptr(), T_init.data_ptr(), T_out.data_ptr(), inlier.data_ptr(),
        B, E, _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "pose_lm_launch")
    pose_lm_batched.launches += 1
    return T_out, inlier


pose_lm_batched.launches = 0


def pose_optimize_cuda(T_init, Xw, uv, valid, K, info=None):
    """Kernel-backed twin of `pose_opt.pose_optimize_plain` for one problem."""
    if T_init.dtype != torch.float32:
        raise TypeError(f"kernel B2 takes f32 poses, got {T_init.dtype}")
    E = Xw.shape[0]
    if info is None:
        info = torch.ones(E, dtype=torch.float32, device=Xw.device)
    k4 = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).to(torch.float32)
    T, inl = pose_lm_batched(
        T_init.contiguous()[None],
        Xw.contiguous()[None],
        uv.contiguous()[None],
        valid.to(torch.float32).contiguous()[None],
        info.contiguous()[None],
        k4[None],
    )
    inlier = (inl[0] > 0.5) & valid
    n_good = torch.sum(inlier.to(torch.int32))
    return se3.orthonormalize(T[0]), inlier, n_good
