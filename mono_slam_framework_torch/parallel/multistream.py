"""Multi-stream batched steady-state tracking (the single-card serving mode).

PyTorch counterpart of `mono_slam_framework_tpu/parallel/multistream.py`.
The reference runs one camera per process (src/main.cpp:100-188). Here N
independent streams' steady frames go through ONE batched call with a
leading stream axis, so the host issues about one frame's worth of device
work for all N streams:

  * extraction: each stream's pyramid, all N streams' detection maps in ONE
    kernel B1 launch (`ops/detect.py::detect_maps_batch`, the counterpart of
    `pallas_detect.detect_stage_multi_bands(..., n_streams=N)`), then the
    top-k, orientation and rBRIEF over the stream axis;
  * matching, association and the two pose LMs:
    `fused_tracking.steady_core_batch`, which carries the stream axis as a
    batch dimension and runs each LM phase as ONE kernel B2 launch for all N
    streams (B = N). The JAX package vmaps `_steady_core` with its XLA LM;
    the port has no XLA LM on the card, so the batched B2 is its route.

Stream i's results equal the single-stream `fused_tracking.steady_step` on
stream i's inputs, bit for bit. `steady_step_loftr_batch` is the LoFTR twin:
one resize and one backbone pass over [N, 1, H, W], then
`fused_loftr.loftr_core_batch` with its two LMs as B2 over N; its batched
products (cuDNN, cuBLAS) may round otherwise than one stream's, so a LoFTR
stream agrees with its one-stream step to float tolerance. Every call runs on
the device of its tensors.

Beyond one card, `steady_step_batch_sharded` and
`steady_step_loftr_batch_sharded` cut the stream axis over a mesh
(`parallel/mesh.py`): each shard is
one `steady_step_batch` / `steady_step_loftr_batch` on its device over its
N/D streams, with no collective in the steady loop (streams are
independent; LoFTR weights and the coarse-cell grid are replicated once per
call), and the results are gathered on the mesh's first device. Every
shard's work is issued before anything waits, so shards on different cards
overlap.
"""

from __future__ import annotations

import torch

from mono_slam_framework_torch.matchers import loftr_matcher as lm
from mono_slam_framework_torch.models import loftr_native
from mono_slam_framework_torch.ops import detect, orb
from mono_slam_framework_torch.parallel import mesh as mesh_mod
from mono_slam_framework_torch.slam import fused_loftr, fused_tracking


def extract_batch(imgs, max_features: int, fast_threshold: float = 20.0) -> orb.Features:
    """`orb.extract` over N streams' images [N, H, W] -> Features with a
    leading stream axis: each stream's pyramid, the detection maps of all N
    streams in one call (`detect.detect_maps_batch`: one kernel B1 launch on
    the card), then the top-k, subpixel, orientation and rBRIEF over the
    stream axis. Stream i's Features equal `orb.extract(imgs[i])` bit for
    bit. The pyramid's products run per stream: batched, cuBLAS picks other
    GEMM kernels whose sums differ in the last bits, which moves subpixel
    positions (ROADMAP C.14)."""
    imgs = imgs.to(torch.float32)
    _, h0, w0 = imgs.shape
    stacks = torch.stack([orb.pyramid(img) for img in imgs])
    maps = detect.detect_maps_batch(stacks, orb._level_dims(h0, w0), fast_threshold, orb.BORDER)
    return orb._post_detect(maps, h0, w0, max_features)


def steady_step_batch(
    imgs,  # [N, H, W] f32
    prev_feats: orb.Features,  # leading [N] axis on every field
    prev_px,  # int32 [N, M]
    prev_row,  # int32 [N, M]
    mp_pos,  # f32 [N, P, 3]
    T_init,  # f32 [N, 4, 4]
    kf_feats: orb.Features,  # [N, NK, K2, ...]
    kf_px,  # int32 [N, NK, M2]
    kf_row,  # int32 [N, NK, M2]
    first_slot,  # int32 [N, R]
    ctx_normal,  # f32 [N, R, 3]
    ctx_maxdist,  # f32 [N, R]
    K,  # f32 [N, 3, 3] per-stream intrinsics
    ratio: float,
    cols: int,
    width: float,
    height: float,
    use_octave_info: bool,
    max_features: int,
    fast_threshold: float,
) -> fused_tracking.SteadyOut:
    """N streams' `fused_tracking.steady_step` as one batched call: the
    SteadyOut of `steady_step` with a leading [N] on every field. One B1
    launch and two B2 launches on a card. Tables padded to common sizes
    keep every stream's result (see `fused_tracking.steady_core_batch`)."""
    cur = extract_batch(imgs, max_features, fast_threshold)
    return fused_tracking.steady_core_batch(
        cur, prev_feats, prev_px, prev_row, mp_pos, T_init, kf_feats, kf_px,
        kf_row, first_slot, ctx_normal, ctx_maxdist, K, ratio, cols, width,
        height, use_octave_info,
    )


def steady_step_loftr_batch(
    imgs,  # [N, H, W] f32
    model,  # loftr_native.LoftrCoarse (shared across streams)
    f_prev,  # [N, 1, L, C]
    prev_cellrow,  # int [N, L]
    mp_pos,  # f32 [N, P, 3]
    T_init,  # f32 [N, 4, 4]
    kf_feats,  # f32 [N, NK, L, C]
    kf_cellrow,  # int [N, NK, L]
    first_slot,  # int32 [N, R]
    ctx_normal,  # f32 [N, R, 3]
    ctx_maxdist,  # f32 [N, R]
    cell_uv,  # f32 [L, 2] (shared: the coarse-cell grid geometry)
    K,  # f32 [N, 3, 3]
    info_val: float,
    threshold: float,
    width: float,
    height: float,
    resize_hw: tuple | None = None,
):
    """N streams' `fused_loftr.steady_step_loftr` as one batched call: one
    backbone pass over the N images, the transformer over N (motion) and
    N x NK (local) pairs, two B2 launches. `resize_hw` is None for images
    at the model's size and the model's (H, W) otherwise: the resize goes
    through `loftr_matcher.to_model`'s weights. Returns (f_cur [N, L, C],
    LoftrOut, union_row [N, L], T2 [N, 4, 4])."""
    h, w = imgs.shape[-2:]
    model_hw = (lm.MODEL_H, lm.MODEL_W)
    if resize_hw != (None if (h, w) == model_hw else model_hw):
        raise ValueError(f"resize_hw {resize_hw} for {h}x{w} images; the model takes {model_hw}")
    f_cur = loftr_native.encode(model, lm.to_model(imgs))
    out, union_row, T2 = fused_loftr.loftr_core_batch(
        f_cur, model, f_prev.reshape(f_cur.shape), prev_cellrow, mp_pos, T_init,
        kf_feats, kf_cellrow, first_slot, ctx_normal, ctx_maxdist, cell_uv, K,
        info_val, threshold, width, height,
    )
    return f_cur, out, union_row, T2


# ---- serving beyond one card: streams cut over a device mesh ---------------


def _shard_args(mesh, args, replicated=()) -> list:
    """Per-shard argument lists: tensors (and NamedTuples of tensors) cut on
    axis 0 over the mesh, the tensors at the positions `replicated` copied to
    every shard, other values passed as they are."""
    cols = []
    for i, a in enumerate(args):
        if torch.is_tensor(a) and i in replicated:
            cols.append(mesh.broadcast(a))
        elif torch.is_tensor(a) or mesh_mod.is_namedtuple(a):
            cols.append(mesh.split(a))
        else:
            cols.append([a] * mesh.size)
    return [list(x) for x in zip(*cols)]


def steady_step_batch_sharded(mesh, *args, **statics) -> fused_tracking.SteadyOut:
    """`steady_step_batch` with the stream axis cut over `mesh`.

    Every tensor argument carries streams on axis 0 (per-stream intrinsics
    included), so the whole argument list splits one way and the steady
    loop runs with no collective: D devices serve D x one device's batch.
    N must be divisible by the mesh size (ValueError otherwise). Returns the
    batch's SteadyOut on the mesh's first device."""
    parts = [steady_step_batch(*a, **statics) for a in _shard_args(mesh, args)]
    return mesh.gather(parts)


# cell_uv and info_val among the arguments after (imgs, model): shared
_LOFTR_REPLICATED = (9, 11)


def steady_step_loftr_batch_sharded(mesh, imgs, model, *args, **statics):
    """`steady_step_loftr_batch` cut over `mesh`: stream tensors split on
    axis 0, the LoFTR model (a replica per device), `cell_uv` and
    `info_val` replicated. Argument order matches `steady_step_loftr_batch`.
    Returns its (f_cur, LoftrOut, union_row, T2) on the first device."""
    parts = [steady_step_loftr_batch(i, m, *a, **statics)
             for i, m, a in zip(mesh.split(imgs), mesh.replicate(model),
                                _shard_args(mesh, args, _LOFTR_REPLICATED))]
    return tuple(mesh.gather(list(x)) for x in zip(*parts))
