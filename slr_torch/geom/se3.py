"""SO(3)/SE(3) Lie-group utilities (port of ``slr/geom/se3.py``).

Used by the ICP Gauss-Newton updates and the pose graph. Poses are
``(R, t)`` with ``R: (...,3,3)``, ``t: (...,3)``; tangent vectors are
``(...,6)`` ordered ``[rho (trans), phi (rot)]``. Every function broadcasts
over leading batch dims. The small-angle branches are Taylor series
selected with ``torch.where``, and the unselected branch of each ``where``
stays NaN-free, so ``torch.func.jacfwd`` through them is clean.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _hat(w):
    """(...,3) -> (...,3,3) skew-symmetric cross-product matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ], dim=-2)


def _mv(A, x):
    """Batched matrix-vector product (...,3,3) x (...,3) -> (...,3)."""
    return (A @ x[..., None])[..., 0]


def _angle2(phi):
    """|phi|^2 as (...,1,1), to scale (...,3,3) matrices. Angles are never
    0-dim tensors here: under ``torch.func.jacfwd`` the tangent of a 0-dim
    tensor plus a Python float comes out float64."""
    return torch.sum(phi * phi, dim=-1)[..., None, None]


def _eye_like(K):
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(phi):
    """Rodrigues: (...,3) rotation vector -> (...,3,3) rotation matrix."""
    theta2 = _angle2(phi)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    # sin(t)/t and (1-cos t)/t^2 with Taylor fallbacks near 0
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    K = _hat(phi)
    return _eye_like(K) + a * K + b * (K @ K)


def so3_log(R):
    """(...,3,3) rotation matrix -> (...,3) rotation vector.

    atan2-based, so differentiable at the identity (an arccos form has an
    infinite derivative there). theta ~ pi needs the symmetric-part
    treatment; scan-to-scan relative poses stay far from it.
    """
    trace = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])[..., None]
    # w = vee(R - R^T), |w| = 2 sin(theta)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    w2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = w2 < 1e-12
    w2_safe = torch.where(small, 1.0, w2)
    nw = torch.sqrt(w2_safe)                      # = 2 sin(theta), grad-safe
    theta = torch.atan2(nw, trace - 1.0)
    # log = (theta / nw) * w; Taylor near 0: 1/2 + theta^2/12, theta^2 ~ 3 - trace
    scale = torch.where(small, 0.5 + (3.0 - trace) / 12.0, theta / nw)
    return scale * w


def _so3_left_jacobian(phi):
    """Left Jacobian J of SO(3): (...,3) -> (...,3,3)."""
    theta2 = _angle2(phi)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    K = _hat(phi)
    return _eye_like(K) + b * K + c * (K @ K)


def _so3_left_jacobian_inv(phi):
    theta2 = _angle2(phi)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    half = theta * 0.5
    cot = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.where(small, 1.0, torch.sin(half)))
        / theta2)
    K = _hat(phi)
    return _eye_like(K) - 0.5 * K + cot * (K @ K)


def se3_exp(xi):
    """(...,6) twist [rho, phi] -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    J = _so3_left_jacobian(phi)
    return so3_exp(phi), _mv(J, rho)


def se3_log(R, t):
    """(R, t) -> (...,6) twist [rho, phi]."""
    phi = so3_log(R)
    rho = _mv(_so3_left_jacobian_inv(phi), t)
    return torch.cat([rho, phi], dim=-1)


def se3_identity(dtype=torch.float32, device="cpu"):
    return (torch.eye(3, dtype=dtype, device=device),
            torch.zeros(3, dtype=dtype, device=device))


def se3_compose(Ra, ta, Rb, tb):
    """(Ra,ta) @ (Rb,tb): apply b first, then a."""
    return Ra @ Rb, _mv(Ra, tb) + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_mv(Rt, t)


def se3_apply(R, t, pts):
    """Transform points: (...,3,3),(...,3) applied to (...,N,3) or (...,3)."""
    if pts.dim() == R.dim() - 1:  # single point per batch element
        return _mv(R, pts) + t
    return pts @ R.transpose(-1, -2) + t[..., None, :]
