"""Tensor-parallel LoFTR: the coarse transformer sharded over a device mesh.

PyTorch counterpart of `mono_slam_framework_tpu/parallel/loftr_tp.py`. The
reference's DNN matcher is a single-threaded CPU ONNX session
(src/dnnfeaturematcher.cpp:50-74); this module is its multi-device scaling
surface. The token (sequence) axis L is cut over the mesh: each device owns
L/n tokens of BOTH feature sets.

* linear attention is tensor-parallel by construction: the only
  cross-token reductions are KV = sum_l k_l v_l^T ([C,C]) and
  Ksum = sum_l k_l ([C]), each one sum of a tiny per-shard partial per
  layer (`Mesh.psum`); queries then produce their messages locally.
* the dual-softmax head gathers the small [L, 32] opposite feature block
  (`Mesh.all_gather`), computes the local [L/n, L] similarity slab, takes
  the row softmax locally and the column softmax through max and sum
  partials (`Mesh.pmax` / `Mesh.psum`).

The products go through `loftr_native._mm`, so they take bf16 operands on a
card and stay f32 on the CPU, as the single-device model does. The output is
the [B, L, L] confidence gathered on the mesh's first device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mono_slam_framework_torch.models import loftr_native
from mono_slam_framework_torch.models.loftr_native import _layernorm, _mm
from mono_slam_framework_torch.parallel.mesh import Mesh


def _layer_tp(mesh: Mesh, lps: list, xs: list, sources: list) -> list:
    """One LoFTR encoder layer on token-sharded [B, Lloc, C] blocks (shard
    i's block, and its replica of the layer's weights, on device i)."""
    v_len = sum(s.shape[1] for s in sources)  # the global token count
    q = [F.elu(_mm(x, lp.wq)) + 1.0 for x, lp in zip(xs, lps)]
    k = [F.elu(_mm(s, lp.wk)) + 1.0 for s, lp in zip(sources, lps)]
    v = [_mm(s, lp.wv) / v_len for s, lp in zip(sources, lps)]
    kv = mesh.psum([_mm(a.transpose(1, 2), b) for a, b in zip(k, v)])  # [B,C,C]
    ksum = mesh.psum([torch.sum(a, dim=1) for a in k])  # [B,C]
    out = []
    for x, lp, qi, kvi, ks in zip(xs, lps, q, kv, ksum):
        z = 1.0 / (_mm(qi, ks[..., None])[..., 0] + loftr_native.ATTN_EPS)  # [B,Lloc]
        msg = _mm(qi, kvi) * z[..., None] * float(v_len)
        msg = _layernorm(_mm(msg, lp.merge), lp.norm1_w, lp.norm1_b)
        m = _mm(F.relu(_mm(torch.cat([x, msg], dim=-1), lp.mlp0)), lp.mlp1)
        out.append(x + _layernorm(m, lp.norm2_w, lp.norm2_b))
    return out


def _confidence_tp(mesh: Mesh, models: list, f0: list, f1: list) -> list:
    """Sharded transformer + dual softmax; returns the row blocks
    [B, Lloc, L] of the confidence, block i on device i."""
    for li, name in enumerate(loftr_native.LAYER_NAMES):
        lps = [m.layers[li] for m in models]
        if name == "self":
            f0 = _layer_tp(mesh, lps, f0, f0)
            f1 = _layer_tp(mesh, lps, f1, f1)
        else:  # sequential cross (original LoFTR order)
            f0 = _layer_tp(mesh, lps, f0, f1)
            f1 = _layer_tp(mesh, lps, f1, f0)
    scale = 1.0 / np.sqrt(float(loftr_native.C))
    f1_full = mesh.all_gather(f1, dim=1)  # [B, L, C] on every shard
    sim = [_mm(a * scale, (b * scale).transpose(1, 2)) / loftr_native.TEMPERATURE
           for a, b in zip(f0, f1_full)]  # [B, Lloc, L]
    # softmax over columns (image-1 cells) is row-local
    s_cols = [torch.softmax(s, dim=2) for s in sim]
    # softmax over rows (image-0 cells) spans shards: global max + sum partials
    row_max = mesh.pmax([torch.amax(s, dim=1) for s in sim])  # [B, L]
    e = [torch.exp(s - mx[:, None, :]) for s, mx in zip(sim, row_max)]
    denom = mesh.psum([torch.sum(a, dim=1) for a in e])  # [B, L]
    return [a / d[:, None, :] * c for a, d, c in zip(e, denom, s_cols)]


@torch.no_grad()
def loftr_tp_confidence(mesh: Mesh, model, f0, f1):
    """Token-sharded confidence: f0/f1 [B, L, C] -> [B, L, L] on the mesh's
    first device.

    L must be divisible by the mesh size (1200 = 8 x 150 on the test mesh).
    `model` (a `LoftrCoarse`, 0.65 MB of weights) is replicated;
    activations and the L x L matrix are cut on the token axis.
    """
    blocks = _confidence_tp(mesh, mesh.replicate(model), mesh.split(f0, 1), mesh.split(f1, 1))
    return mesh.gather(blocks, dim=1)
