"""Pose-graph optimisation over scanner poses (port of
``slr/registration/posegraph.py``).

Variables: per-scan rig poses T_s in SE(3) (world <- scan). Residuals: for
each edge (i, j) with measured relative pose Z_ij, r = log(Z_ij^-1 T_i^-1
T_j) in R^6. Gauss-Newton with the Jacobian from ``torch.func.jacfwd`` over
the stacked tangent increments, gauge-fixed by anchoring pose 0, solved
densely (the pose block is 6S x 6S).

CUDA tensors take the whole solve in one launch of a kernel written by hand
(``kernels/csrc/pose_graph.cu``, float32, counted as
``launches.pose_graph``); CPU tensors take the loop below, the kernel's
plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from slr_torch.geom.se3 import se3_compose, se3_exp, se3_inverse, se3_log
from slr_torch.kernels import pose_graph as kernel


class PoseGraphResult(NamedTuple):
    R: torch.Tensor      # (S,3,3) world <- scan rotations
    t: torch.Tensor      # (S,3)
    cost: torch.Tensor   # final sum of squared residuals
    rms: torch.Tensor    # per-residual-component RMS


def _apply_updates(xi_all, R0, t0):
    """T_s = T0_s Exp(xi_s) for every pose."""
    dR, dt = se3_exp(xi_all)
    return R0 @ dR, torch.einsum("sij,sj->si", R0, dt) + t0


def _edge_residuals(xi_all, R0, t0, edges_i, edges_j, Zr, Zt, scale):
    """Residuals of all edges for tangent updates xi (S,6) on the right of
    the initial poses. ``scale`` (6,) is [1, 1, 1, rot_scale x 3]: rot_scale
    (mm per radian) turns the rotation rows into the point displacement they
    cause, so a redundant graph does not trade degrees for millimetres."""
    R, t = _apply_updates(xi_all, R0, t0)
    Rii, tii = se3_inverse(R[edges_i], t[edges_i])
    Rij, tij = se3_compose(Rii, tii, R[edges_j], t[edges_j])   # T_i^-1 T_j
    Er, Et = se3_compose(*se3_inverse(Zr, Zt), Rij, tij)       # Z^-1 T_i^-1 T_j
    return (se3_log(Er, Et) * scale).reshape(-1)


def pose_graph_optimize(
    R_init,              # (S,3,3)
    t_init,              # (S,3)
    edges_i,             # (E,) int
    edges_j,             # (E,) int
    Z_R,                 # (E,3,3) measured relative poses scan_i -> scan_j
    Z_t,                 # (E,3)
    iters: int = 20,
    damping: float = 1e-6,
    rot_scale: float = 300.0,
) -> PoseGraphResult:
    """``iters`` Gauss-Newton iterations over the poses. CUDA tensors launch
    the kernel once (float32; other dtypes raise ``ValueError``); CPU
    tensors run ``pose_graph_optimize_reference``."""
    if R_init.device.type == "cuda":
        return PoseGraphResult(*kernel.solve(R_init, t_init, edges_i.long(), edges_j.long(),
                                             Z_R, Z_t, iters, damping, rot_scale))
    return pose_graph_optimize_reference(R_init, t_init, edges_i, edges_j, Z_R, Z_t, iters,
                                         damping, rot_scale)


def pose_graph_optimize_reference(R_init, t_init, edges_i, edges_j, Z_R, Z_t,
                                  iters: int = 20, damping: float = 1e-6,
                                  rot_scale: float = 300.0) -> PoseGraphResult:
    """The plain version: each iteration's Jacobian by ``jacfwd``, the
    normal equations solved by ``cholesky_ex`` and ``cholesky_solve``."""
    S = R_init.shape[0]
    dev = R_init.device
    scale = torch.ones(6, device=dev)
    scale[3:] = rot_scale
    # gauge fix: anchor pose 0 (a huge diagonal on its block), plus damping
    diag = torch.full((6 * S,), damping, device=dev)
    diag[:6] += 1e12
    x0 = torch.zeros(6 * S, device=dev)
    R, t = R_init, t_init
    for _ in range(iters):
        def res_of(xi_flat, R0=R, t0=t):
            return _edge_residuals(xi_flat.reshape(S, 6), R0, t0, edges_i, edges_j,
                                   Z_R, Z_t, scale)

        r = res_of(x0)
        J = jacfwd(res_of)(x0)
        H = J.T @ J + torch.diag(diag)
        L, _ = torch.linalg.cholesky_ex(H)
        dx = -torch.cholesky_solve((J.T @ r)[:, None], L)[:, 0]
        R, t = _apply_updates(dx.reshape(S, 6), R, t)
    r_fin = _edge_residuals(torch.zeros((S, 6), device=dev), R, t, edges_i, edges_j,
                            Z_R, Z_t, scale)
    cost = torch.sum(r_fin * r_fin)
    return PoseGraphResult(R=R, t=t, cost=cost, rms=torch.sqrt(cost / r_fin.shape[0]))
