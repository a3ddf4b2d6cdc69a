"""Multi-device scaling: the batched matcher A/B sweep.

PyTorch counterpart of `mono_slam_framework_tpu/parallel/sweep.py`. The
reference is a single-process system with no distributed backend; the
natural multi-device surface of this framework is throughput: many frame
pairs or matcher variants at once, data-parallel over a mesh
(`parallel/mesh.py`), each device running the whole per-frame tracking
compute (feature extraction -> matching -> pose LM) on its share.

Each shard's work is issued to its device from this one process and nothing
between the issue and the final gather waits on the host, so shards on
different cards overlap. On a card a shard's extraction of each image set
is one kernel B1 launch (`multistream.extract_batch`) and its pose LMs are
one kernel B2 launch (`pose_opt.pose_optimize_batched`, B = the shard's
pairs). No shard talks to another: the results are gathered at the end.
"""

from __future__ import annotations

import torch

from mono_slam_framework_torch.models import loftr_native
from mono_slam_framework_torch.ops import hamming, orb
from mono_slam_framework_torch.optim import pose_opt
from mono_slam_framework_torch.parallel import multistream
from mono_slam_framework_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["make_mesh", "sharded_loftr_sweep", "sharded_matcher_sweep", "sharded_tracking_step"]


def _pair_step(img1, img2, max_features: int, ratio: float):
    """Single-pair tracking compute: extract both, match, return matches
    (xy1 [K,2], xy2 [K,2], ok [K])."""
    f1 = orb.extract(img1, max_features)
    f2 = orb.extract(img2, max_features)
    d = hamming.distance_matrix(f1.desc, f2.desc, f1.valid, f2.valid)
    idx2, ok = hamming.knn2_ratio_match(d, ratio)
    ok = ok & f1.valid
    return f1.xy, f2.xy[idx2], ok


def _pairs_step(imgs1, imgs2, max_features: int, ratio: float):
    """`_pair_step` over a batch of pairs [b, H, W]: each image set's
    extraction in one call (one B1 launch on a card), the matching batched
    over the pairs. Pair i's outputs equal `_pair_step` on pair i."""
    f1 = multistream.extract_batch(imgs1, max_features)
    f2 = multistream.extract_batch(imgs2, max_features)
    d = hamming.distance_matrix(f1.desc, f2.desc, f1.valid, f2.valid)
    idx2, ok = hamming.knn2_ratio_match(d, ratio)
    ok = ok & f1.valid
    xy2 = torch.gather(f2.xy, 1, idx2[..., None].expand(-1, -1, 2))
    return f1.xy, xy2, ok


def sharded_matcher_sweep(
    mesh: Mesh,
    images1,
    images2,
    max_features: int = 512,
    ratio: float = 0.7,
):
    """Match a batch of frame pairs, sharded over the mesh.

    images1/images2: [B, H, W] with B divisible by the mesh size.
    Returns (xy1 [B,K,2], xy2 [B,K,2], ok [B,K]) on the mesh's first device.
    """
    parts = [_pairs_step(a, b, max_features, ratio)
             for a, b in zip(mesh.split(images1), mesh.split(images2))]
    return tuple(mesh.gather(list(x)) for x in zip(*parts))


def sharded_loftr_sweep(mesh: Mesh, model, feats1, feats2, max_matches: int = 256):
    """Data-parallel LoFTR A/B surface: a batch of encoded feature pairs cut
    over the mesh, each device running the pairwise coarse transformer and
    the top-k decode (`loftr_native.match_features_topk`) on its pairs with
    its replica of `model` (a `LoftrCoarse`; the JAX function loads its
    params itself). Complements the token-sharded tensor-parallel form in
    `parallel/loftr_tp.py`.

    feats1/feats2: [B, L, C] encoded frame features (B divisible by the mesh
    size). Returns (vals [B, K], flat_idx [B, K]) per pair on the first
    device.
    """
    parts = [loftr_native.match_features_topk(m, a, b, max_matches)
             for m, a, b in zip(mesh.replicate(model), mesh.split(feats1), mesh.split(feats2))]
    return tuple(mesh.gather(list(x)) for x in zip(*parts))


def sharded_tracking_step(
    mesh: Mesh,
    images1,
    images2,
    T_init,
    points,
    uv_obs,
    valid,
    K,
    max_features: int = 256,
    ratio: float = 0.7,
):
    """The whole per-frame device compute, batched and sharded: ORB
    extraction on both images, Hamming matching, and motion-only pose LM
    (the starred stages of SURVEY.md §3.1) for each shard's pairs.

    Shapes: images [B,H,W]; T_init [B,4,4]; points [B,N,3]; uv_obs [B,N,2];
    valid [B,N]; K [3,3]. B divisible by the mesh size.
    Returns (T_opt [B,4,4], n_inliers [B], n_matches [B]) on the first device.
    """
    outs = []
    for i1, i2, T0, X, uv, v, Kd in zip(
            *(mesh.split(x) for x in (images1, images2, T_init, points, uv_obs, valid)),
            mesh.broadcast(K)):
        _, _, ok = _pairs_step(i1, i2, max_features, ratio)
        T_opt, _, n_good = pose_opt.pose_optimize_batched(
            T0, X, uv, v, Kd.expand(T0.shape[0], 3, 3))
        outs.append((T_opt, n_good, torch.sum(ok.to(torch.int32), dim=1, dtype=torch.int32)))
    return tuple(mesh.gather(list(x)) for x in zip(*outs))
