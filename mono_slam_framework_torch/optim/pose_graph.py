"""Pose-graph (essential-graph) optimization for loop correction.

PyTorch counterpart of `mono_slam_framework_tpu/optim/pose_graph.py`.
Upstream ORB-SLAM2 distributes a detected loop's correction around the whole
trajectory with OptimizeEssentialGraph (a g2o Sim3 pose graph) before the
global BA; the reference fork dropped that step with its Sim3 solver
(LoopClosing.cc:101-115 runs only a global BA).

Nodes are SE(3) world->camera poses; edges carry relative-pose measurements
T_ij = T_i @ T_j^-1 taken from the pre-correction estimates, plus the loop
edge from the fitted loop correction. Each damped Gauss-Newton iteration
linearizes the stacked weighted edge residuals
r_k = log_se3(T_meas^-1 T_i T_j^-1) * sqrt(w_k) under a left perturbation
exp(xi) T of every node, solves the [6N, 6N] normal equations on the device
and left-multiplies each free pose by exp_se3 of its step. The iterations
are a Python loop of device ops with no host read inside; the one read is
the finite check at the end.

The Jacobian is analytic and per edge (`_edge_jacobians`, [6, 12]) where
the JAX package takes `jax.jacfwd` of the residuals: the same derivative.
`torch.func.jacfwd` is not used because its first call in a process imports
`torch._dynamo` (~8 s on the card) and leaves its objects for every later
garbage collection to walk.

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


def _adjoint(T):
    """Ad(T) [..., 6, 6] in the [omega, upsilon] ordering:
    T exp(xi) T^-1 = exp(Ad(T) xi)."""
    R = T[..., :3, :3]
    return torch.cat([torch.cat([R, torch.zeros_like(R)], -1),
                      torch.cat([se3.hat(T[..., :3, 3]) @ R, R], -1)], -2)


def _q_block(w, v):
    """Q(v, w) [..., 3, 3], the lower-left block of the SE(3) left Jacobian
    [[J(w), 0], [Q, J(w)]] at the tangent [w, v] (Barfoot, "State Estimation
    for Robotics", 7.86). Its coefficients are cancellations of order
    theta^3..theta^5, so they are taken in float64, from the Taylor series
    below theta = 0.1."""
    th2 = torch.sum(w * w, dim=-1).double()
    small = th2 < 1e-2
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    s, c = torch.sin(th), torch.cos(th)
    c1 = torch.where(small, 1 / 6 - th2 / 120 + th2 * th2 / 5040, (th - s) / th ** 3)
    c2 = torch.where(small, 1 / 24 - th2 / 720 + th2 * th2 / 40320,
                     (th2 + 2 * c - 2) / (2 * th2 * th2))
    c3 = torch.where(small, 1 / 120 - th2 / 2520 + th2 * th2 / 120960,
                     (2 * th - 3 * s + th * c) / (2 * th ** 5))
    c1, c2, c3 = (x.to(w.dtype)[..., None, None] for x in (c1, c2, c3))
    W, V = se3.hat(w), se3.hat(v)
    WV, VW = W @ V, V @ W
    WVW = WV @ W
    return (0.5 * V + c1 * (WV + VW + WVW) + c2 * (W @ WV + VW @ W - 3.0 * WVW)
            + c3 * (WVW @ W + W @ WVW))


def _left_jacobian_inv(xi):
    """Inverse left Jacobian of SE(3) at tangents xi [..., 6]:
    log(exp(d) exp(xi)) = xi + J(xi) d + O(d^2). In closed form
    [[Ji, 0], [-Ji Q Ji, Ji]] with Ji the inverse left Jacobian of SO(3)."""
    w, v = xi[..., :3], xi[..., 3:]
    Ji = se3.so3_left_jacobian_inv(w)
    return torch.cat([torch.cat([Ji, torch.zeros_like(Ji)], -1),
                      torch.cat([-(Ji @ _q_block(w, v) @ Ji), Ji], -1)], -2)


def _edge_jacobians(T_nodes, e_i, e_j, T_meas_inv, w_sqrt):
    """The weighted residuals [E, 6] and their derivatives [E, 6, 6] by the
    left perturbations a of node i and b of node j. With the edge error
    D = T_meas^-1 T_i T_j^-1 and r = log(D),
    T_meas^-1 exp(a) T_i T_j^-1 exp(-b) = exp(Ad(T_meas^-1) a - Ad(D) b) D
    to first order, so dr/da = J(r) Ad(T_meas^-1) and dr/db = -J(r) Ad(D)."""
    D = se3.compose(T_meas_inv, se3.compose(T_nodes[e_i], se3.inverse(T_nodes[e_j])))
    r = se3.log_se3(D)
    Jw = _left_jacobian_inv(r) * w_sqrt[:, None, None]
    return r * w_sqrt[:, None], Jw @ _adjoint(T_meas_inv), -(Jw @ _adjoint(D))


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
    at_i = torch.nn.functional.one_hot(e_i, N).to(f32)[:, None, :, None]  # [E, 1, N, 1]
    at_j = torch.nn.functional.one_hot(e_j, N).to(f32)[:, None, :, None]

    for _ in range(iters):
        r, J_i, J_j = _edge_jacobians(T_cur, e_i, e_j, T_meas_inv, w_sqrt)
        r0 = r.reshape(-1)
        # [E, 6, N, 6] -> [6E, 6N]: each edge's two blocks in its nodes' columns
        J = (J_i[:, :, None, :] * at_i + J_j[:, :, None, :] * at_j).reshape(-1, N * 6)
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
