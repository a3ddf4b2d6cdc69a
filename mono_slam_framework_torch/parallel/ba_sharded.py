"""Mesh-sharded global bundle adjustment.

PyTorch counterpart of `mono_slam_framework_tpu/parallel/ba_sharded.py`.
The loop-closure global BA (Optimizer.cc:62-215 at full-map scale) is the
one optimization whose edge count outgrows a single device: every
(keyframe, map point) observation is an edge, and a long sequence carries
hundreds of thousands. The matrix-free PCG solver (`optim/bundle_adjust.py`,
`global_bundle_adjust`) is O(E) segment-scatter work per CG application,
the shape that data-parallelizes: the EDGES are cut over the mesh, the
camera and landmark states stay replicated, and every edge->global
reduction becomes a sum of the shards' partials (`Mesh.reduce_sum`, in mesh
order on the first device, where the replicated math runs once).

The only traffic is the [C,6,6] / [P,3,3] / [C,6] / [P,3] partials per
reduction and the replicated state copied back to the shards. A mesh of one
shard gives `global_bundle_adjust`'s result bit for bit; more shards sum the
same partials in another order (tests/test_torch_parallel.py).
"""

from __future__ import annotations

import torch

from mono_slam_framework_torch.optim.bundle_adjust import BAProblem, _lm_iterations
from mono_slam_framework_torch.parallel.mesh import Mesh, make_mesh

AXIS = "edges"


def make_ba_mesh(n_devices: int | None = None) -> Mesh:
    """The edge mesh over every visible card (the first `n_devices`); raises
    without a card, as `make_mesh` does."""
    return make_mesh(n_devices, axis=AXIS)


def _pad_edges(p: BAProblem, ndev: int) -> BAProblem:
    """Pad the edge arrays to a multiple of the mesh size (invalid fill,
    information 1)."""
    E = p.e_cam.shape[0]
    pad = -E % ndev
    if pad == 0:
        return p

    def padv(a, fill=0):
        return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                                        device=a.device)])

    return p._replace(
        e_cam=padv(p.e_cam),
        e_pt=padv(p.e_pt),
        e_uv=padv(p.e_uv),
        e_valid=padv(p.e_valid, False),
        e_info=padv(p.e_info, 1.0),
    )


def global_bundle_adjust_sharded(
    mesh: Mesh,
    p: BAProblem,
    n_iters: int = 20,
    robust: bool = True,
    cg_iters: int = 60,
):
    """Edge-sharded twin of `global_bundle_adjust`.

    Returns (cam_T, points, chi2) on the problem's device, matching the
    single-device cg path to float rounding (same LM schedule; the sum of
    the partials is the full reduction)."""
    home = p.cam_T.device
    p = _pad_edges(p, mesh.size)
    first = mesh.first
    p = p._replace(cam_T=p.cam_T.to(first), cam_fixed=p.cam_fixed.to(first),
                   points=p.points.to(first), K=p.K.to(first))
    mask = p.e_valid.to(p.cam_T.dtype)
    T, X, chi = _lm_iterations(p.cam_T, p.points, p, mask, robust, int(n_iters),
                               solver="cg", cg_iters=int(cg_iters), mesh=mesh)
    return T.to(home), X.to(home), chi.to(home)
