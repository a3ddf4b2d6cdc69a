"""Shared Levenberg-Marquardt machinery (g2o-compatible policies).

PyTorch counterpart of `mono_slam_framework_tpu/optim/lm.py`:

  * initial damping  lambda0 = tau * max_i H_ii  with tau = 1e-5;
  * additive damping (H + lambda*I);
  * Nielsen gain-ratio policy: on accept
      lambda *= max(1/3, 1 - (2*rho - 1)^3),  nu = 2
    on reject
      lambda *= nu,  nu *= 2  (and the step is rolled back);
  * Huber robust kernel with delta = sqrt(5.991) as IRLS weights;
  * the edge chi2 used for outlier classification is the raw squared error,
    while the LM accept decision uses the robustified total chi2.
"""

from __future__ import annotations

import math

import torch

TAU = 1e-5
CHI2_MONO = 5.991
HUBER_DELTA2 = 5.991
HUBER_DELTA = math.sqrt(HUBER_DELTA2)


def huber_weight(e2, use_huber: bool):
    """IRLS weight for squared error e2 under the Huber kernel."""
    if not use_huber:
        return torch.ones_like(e2)
    safe = torch.clamp(e2, min=1e-12)
    return torch.where(e2 <= HUBER_DELTA2, 1.0, HUBER_DELTA / torch.sqrt(safe))


def huber_rho(e2, use_huber: bool):
    """Robustified chi2 contribution rho(e2) (for the LM accept decision)."""
    if not use_huber:
        return e2
    safe = torch.clamp(e2, min=1e-12)
    rob = 2.0 * HUBER_DELTA * torch.sqrt(safe) - HUBER_DELTA2
    return torch.where(e2 <= HUBER_DELTA2, e2, rob)


def nielsen_update(lam, nu, rho, accepted):
    """Nielsen lambda schedule (g2o OptimizationAlgorithmLevenberg)."""
    shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    lam_new = torch.where(accepted, lam * shrink, lam * nu)
    nu_new = torch.where(accepted, torch.full_like(nu, 2.0), nu * 2.0)
    return lam_new, nu_new


def projection_jacobians(Xc, fx, fy):
    """d(uv)/d(point-in-camera) for pinhole projection: [..., 3] -> [..., 2, 3]."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zs = torch.where(z == 0, torch.ones_like(z), z)
    iz = 1.0 / zs
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    row0 = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
    row1 = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def se3_point_jacobian(Xc):
    """d(point-in-camera)/d(xi) for the left update exp(xi)*T,
    xi = [omega, upsilon]: [..., 3] -> [..., 3, 6] = [ -[Xc]x | I ]."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r0 = torch.stack([zero, z, -y, one, zero, zero], dim=-1)
    r1 = torch.stack([-z, zero, x, zero, one, zero], dim=-1)
    r2 = torch.stack([y, -x, zero, zero, zero, one], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)
