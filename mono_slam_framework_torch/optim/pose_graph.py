"""Pose-graph (essential-graph) optimization for loop correction.

PyTorch counterpart of `mono_slam_framework_tpu/optim/pose_graph.py`.
Upstream ORB-SLAM2 distributes a detected loop's correction around the whole
trajectory with OptimizeEssentialGraph (a g2o Sim3 pose graph) before the
global BA; the reference fork dropped that step with its Sim3 solver
(LoopClosing.cc:101-115 runs only a global BA).

Nodes are SE(3) world->camera poses; edges carry relative-pose measurements
T_ij = T_i @ T_j^-1 taken from the pre-correction estimates, plus the loop
edge from the fitted loop correction. Each damped Gauss-Newton iteration
takes the dense [6E, 6N] Jacobian of the stacked weighted edge residuals
r_k = log_se3(T_meas^-1 T_i T_j^-1) * sqrt(w_k) by forward-mode autodiff
(`torch.func.jacfwd`) at the current linearization point, solves the
[6N, 6N] normal equations on the device and left-multiplies each free pose
by exp_se3 of its step. The iterations are a Python loop of device ops with
no host read inside; the one read is the finite check at the end.

Graphs go in at their own size: the JAX package's node and edge capacity
ladders and its padded-edge mask are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from mono_slam_framework_torch.geometry import se3


def _edge_residuals(T_nodes, e_i, e_j, T_meas_inv, w_sqrt):
    """Stacked weighted residuals [E, 6]."""
    rel = se3.compose(T_nodes[e_i], se3.inverse(T_nodes[e_j]))
    return se3.log_se3(se3.compose(T_meas_inv, rel)) * w_sqrt[:, None]


def optimize_pose_graph(T_nodes, fixed, e_i, e_j, T_meas, e_weight,
                        iters: int = 15, damping: float = 1e-6):
    """Damped GN on the SE(3) pose graph, on the tensors' device.

    T_nodes [N,4,4] f32 world->camera poses (initial estimate); fixed [N]
    bool gauge anchors (kept exactly); e_i, e_j [E] int64 node indices;
    T_meas [E,4,4] measured T_i @ T_j^-1; e_weight [E]. Returns
    (T_opt [N,4,4], final cost)."""
    N = T_nodes.shape[0]
    f32 = torch.float32
    dev = T_nodes.device
    T_cur = T_nodes.to(f32)
    w_sqrt = torch.sqrt(e_weight.to(f32))
    T_meas_inv = se3.inverse(T_meas.to(f32))
    free6 = (~fixed).to(f32).repeat_interleave(6)  # [6N]
    eye = torch.eye(N * 6, dtype=f32, device=dev)
    zero = torch.zeros(N * 6, dtype=f32, device=dev)

    for _ in range(iters):
        def res_of(xi_flat, T_lin=T_cur):
            T = se3.compose(se3.exp_se3(xi_flat.reshape(N, 6)), T_lin)
            return _edge_residuals(T, e_i, e_j, T_meas_inv, w_sqrt).reshape(-1)

        r0 = res_of(zero)
        J = torch.func.jacfwd(res_of)(zero)  # [6E, 6N]
        # freeze fixed nodes: zero their columns, unit diagonal
        J = J * free6[None, :]
        H = J.T @ J
        g = J.T @ r0
        lam = damping * (torch.trace(H) / (N * 6) + 1.0)
        H = H + lam * eye + torch.diag(1.0 - free6)  # keep fixed blocks invertible
        dx = -torch.linalg.solve(H, g) * free6
        T_cur = se3.orthonormalize(se3.compose(se3.exp_se3(dx.reshape(N, 6)), T_cur))

    cost = torch.sum(_edge_residuals(T_cur, e_i, e_j, T_meas_inv, w_sqrt) ** 2)
    return T_cur, cost


def optimize_pose_graph_np(
    T_nodes: np.ndarray,
    fixed: np.ndarray,
    e_i,
    e_j,
    T_meas: np.ndarray,
    e_weight=None,
    iters: int = 15,
    device="cuda",
):
    """Host wrapper: numpy in, the optimized [N,4,4] poses out, solved on
    `device`. A non-finite result returns None: a degenerate graph must
    degrade to "no correction", never scramble the map."""
    dev = torch.device(device)

    def to(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    e = len(e_i)
    w = np.ones(e, np.float32) if e_weight is None else e_weight
    T_out, _ = optimize_pose_graph(
        to(T_nodes, np.float32), to(fixed, np.bool_), to(e_i, np.int64),
        to(e_j, np.int64), to(T_meas, np.float32), to(w, np.float32), iters=iters,
    )
    out = T_out.cpu().numpy()
    if not np.isfinite(out).all():
        return None
    return out
