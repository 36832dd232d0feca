"""Schur-complement bundle adjustment over scanner poses (port of
``slr/dist/ba.py``).

Model: S scan poses T_s = (R_s, t_s) (scan -> world) and L landmarks X_l
(world). Observation (l, k): landmark l measured at p in the frame of scan
s_k; the residual is r = R_s^T (X_l - t_s) - p (3 rows), or with normals
n . (R_s^T (X_l - t_s) - p) (one row, point-to-plane). Right-perturbation
linearisation (T <- T Exp(xi), xi = [tau, omega]): J_pose = [-I | hat(x0)],
J_X = R_s^T, x0 = R_s^T (X_l - t_s).

Each residual touches one pose, so the pose block is block-diagonal and the
landmark blocks are 3 x 3; eliminating them gives the reduced 6S x 6S pose
system H_red = H_pp - sum_l W_l H_ll^-1 W_l^T, g_red = g_p - W H_ll^-1 g_l,
solved by Cholesky, then each landmark back-substitutes. The pose-indexed
sums are float32 products with one-hot matrices, as the reference's, never
float atomics.

``distributed_bundle_adjust`` splits the landmarks over the ``map_block``
axis: each block assembles its share of the reduced system, one
``all_reduce`` of one float32 buffer [H_red, g_red, cost, nres] a
Gauss-Newton iteration sums it (the reference's four ``psum``s stacked into
one), every rank solves the small pose system alike, and each block
back-substitutes its own landmarks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from slr_torch.dist import comm
from slr_torch.geom.se3 import _hat, se3_exp


class BAResult(NamedTuple):
    R: torch.Tensor       # (S,3,3) refined scan -> world rotations
    t: torch.Tensor       # (S,3)
    X: torch.Tensor       # (L,3) refined landmarks
    cost: torch.Tensor    # final weighted SSE
    rms: torch.Tensor     # per-residual-row RMS


def _inv3x3(A):
    """Batched closed-form 3x3 inverse by the adjugate; (..., 3, 3). The
    landmark blocks are SPD plus a Tikhonov term, so the determinant stays
    away from zero (clamped at 1e-30 in magnitude all the same)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    det = torch.where(det.abs() < 1e-30, 1e-30, det)
    adj = torch.stack([torch.stack([c00, c01, c02], -1),
                       torch.stack([c10, c11, c12], -1),
                       torch.stack([c20, c21, c22], -1)], -2)
    return adj / det[..., None, None]


def _assemble_block(R, t, X, obs_s, obs_p, obs_w, S: int, damping: float,
                    huber_delta: float = 0.0, obs_n=None):
    """Schur assembly over the landmarks.

    X (L,3); obs_s (L,K) int; obs_p (L,K,3); obs_w (L,K) weights (0 =
    missing). ``huber_delta`` > 0: IRLS Huber weights, residuals beyond
    delta down-weighted by delta / |r|. ``obs_n`` (L,K,3), scan-frame
    normals at obs_p, switches to point-to-plane rows (blind to in-plane
    offsets between distinct subsamples); then the landmark Tikhonov term is
    at least 1e-2, since plane rows leave a landmark free in its tangent
    plane. The row axis ``a`` carries both cases (3 rows or 1).
    Returns (H_red (6S,6S), g_red (6S,), cost, nres, (H_ll_inv, g_l, W)).
    """
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    obs_s = obs_s.long()
    Rs = R[obs_s]                                           # (L,K,3,3)
    ts = t[obs_s]                                           # (L,K,3)
    x0 = torch.einsum("lkij,lki->lkj", Rs, X[:, None, :] - ts)   # R^T (X - t)
    if huber_delta > 0.0:
        if obs_n is None:
            rn = torch.linalg.norm(x0 - obs_p, dim=-1)
        else:
            rn = torch.abs(torch.einsum("lki,lki->lk", obs_n, x0 - obs_p))
        obs_w = obs_w * torch.where(rn > huber_delta,
                                    huber_delta / rn.clamp(min=1e-12), 1.0)
    w = obs_w[..., None]
    sw = torch.sqrt(torch.where(w > 0, w, 0.0))
    if obs_n is None:
        # whitened J_pose = [-I | hat(x0)], J_X = R^T, residual
        U = torch.cat([(-eye3).expand(x0.shape[:-1] + (3, 3)), _hat(x0)], dim=-1)
        U1 = U * sw[..., None]                              # (L,K,3,6)
        V1 = Rs.transpose(-1, -2) * sw[..., None]           # (L,K,3,3)
        r1 = (x0 - obs_p) * sw                              # (L,K,3)
        damping_ll = damping
        res_rows = 3.0
    else:
        # scalar rows: J_pose = [-n | n x x0], J_X = (R n)^T
        U = torch.cat([-obs_n, torch.cross(obs_n, x0, dim=-1)], dim=-1)
        U1 = (U * sw)[..., None, :]                         # (L,K,1,6)
        V1 = (torch.einsum("lkij,lkj->lki", Rs, obs_n) * sw)[..., None, :]
        r1 = (torch.einsum("lki,lki->lk", obs_n, x0 - obs_p) * sw[..., 0])[..., None]
        damping_ll = max(damping, 1e-2)
        res_rows = 1.0

    UtU = torch.einsum("lkai,lkaj->lkij", U1, U1)
    Utr = torch.einsum("lkai,lka->lki", U1, r1)
    onehot = F.one_hot(obs_s.reshape(-1), S).to(U1.dtype)  # (N,S)
    H_pp = torch.einsum("nij,ns->sij", UtU.reshape(-1, 6, 6), onehot)
    g_p = torch.einsum("ni,ns->si", Utr.reshape(-1, 6), onehot)

    H_ll = torch.einsum("lkai,lkaj->lij", V1, V1) + damping_ll * eye3
    g_l = torch.einsum("lkai,lka->li", V1, r1)              # (L,3)
    W = torch.einsum("lkai,lkaj->lkij", U1, V1)             # (L,K,6,3)
    H_ll_inv = _inv3x3(H_ll)
    # Schur cross terms: every (k1, k2) pose pair of a landmark
    WHW = torch.einsum("lkij,ljm,lqnm->lkqin", W, H_ll_inv, W)   # (L,K,K,6,6)
    pair_seg = (obs_s[:, :, None] * S + obs_s[:, None, :]).reshape(-1)
    pair_hot = F.one_hot(pair_seg, S * S).to(U1.dtype)
    H_cross = torch.einsum("nij,np->pij", WHW.reshape(-1, 6, 6),
                           pair_hot).reshape(S, S, 6, 6)
    Whg = torch.einsum("lkij,ljm,lm->lki", W, H_ll_inv, g_l)     # (L,K,6)
    g_cross = torch.einsum("ni,ns->si", Whg.reshape(-1, 6), onehot)

    H_red = -H_cross
    diag = torch.arange(S, device=X.device)
    H_red[diag, diag] += H_pp
    g_red = g_p - g_cross
    cost = torch.sum(r1 * r1)
    nres = res_rows * torch.sum((obs_w > 0).to(torch.float32))
    return (H_red.permute(0, 2, 1, 3).reshape(6 * S, 6 * S), g_red.reshape(-1),
            cost, nres, (H_ll_inv, g_l, W))


def _back_substitute(H_ll_inv, g_l, W, obs_s, dxi, S: int):
    """dX_l = -H_ll^-1 (g_l + sum_k W_k^T dxi_{s_k})."""
    Wtd = torch.einsum("lkij,lki->lj", W, dxi.reshape(S, 6)[obs_s])
    return -torch.einsum("lij,lj->li", H_ll_inv, g_l + Wtd)


def _ba_iteration(R, t, X, obs_s, obs_p, obs_w, S: int, damping: float,
                  huber_delta: float = 0.0, obs_n=None, group=None):
    """One Gauss-Newton step: assemble, anchor pose 0 (1e12 on its diagonal)
    and damp the pose block, solve by Cholesky (no host check), back-
    substitute the landmarks, update T <- T Exp(dxi). With a ``group`` the
    assembly is this block's share, summed over the group by one
    ``all_reduce`` of [H_red, g_red, cost, nres]."""
    H_red, g_red, cost, nres, (H_ll_inv, g_l, W) = _assemble_block(
        R, t, X, obs_s, obs_p, obs_w, S, damping, huber_delta, obs_n)
    if group is not None:
        n = 6 * S
        buf = comm.all_reduce_(torch.cat([H_red.reshape(-1), g_red, cost[None],
                                          nres[None]]), group)
        H_red, g_red = buf[:n * n].reshape(n, n), buf[n * n:n * n + n]
        cost, nres = buf[-2], buf[-1]
    anchor = torch.zeros(6 * S, dtype=H_red.dtype, device=H_red.device)
    anchor[:6] = 1e12
    H_red = H_red + torch.diag(anchor + damping)
    L, _ = torch.linalg.cholesky_ex(H_red)
    dxi = -torch.cholesky_solve(g_red[:, None], L)[:, 0]
    dX = _back_substitute(H_ll_inv, g_l, W, obs_s, dxi, S)
    dR, dt = se3_exp(dxi.reshape(S, 6))
    return R @ dR, torch.einsum("sij,sj->si", R, dt) + t, X + dX, cost, nres


def bundle_adjust_reference(R, t, X, obs_s, obs_p, obs_w, iters: int = 10,
                            damping: float = 1e-6, huber_delta: float = 0.0,
                            obs_n=None) -> BAResult:
    """Single-device BA: ``iters`` Gauss-Newton steps; cost and rms are
    those assembled in the last step (before its update)."""
    S = R.shape[0]
    for _ in range(iters):
        R, t, X, cost, nres = _ba_iteration(R, t, X, obs_s, obs_p, obs_w, S, damping,
                                            huber_delta=huber_delta, obs_n=obs_n)
    return BAResult(R=R, t=t, X=X, cost=cost, rms=torch.sqrt(cost / nres))


def distributed_bundle_adjust(R, t, X, obs_s, obs_p, obs_w, mesh, iters: int = 10,
                              damping: float = 1e-6, huber_delta: float = 0.0,
                              obs_n=None) -> BAResult:
    """The BA with the landmarks split over ``mesh``'s map_block axis (L
    divisible by its size). Every rank passes the whole problem: the poses
    (S,3,3), (S,3), the landmarks (L,3) and their observations (L,K),
    (L,K,3), (L,K) (and normals (L,K,3) for plane rows). One
    ``all_reduce`` a Gauss-Newton iteration crosses blocks; the pose solve
    is replicated, the landmark updates block-local, and X is gathered back
    to (L,3) in block order, so every rank returns the same bits."""
    nb, b = mesh.shape["map_block"], mesh.coords["map_block"]
    L = X.shape[0]
    if L % nb:
        raise ValueError(f"{L} landmarks do not split over {nb} map blocks")
    blk = slice(b * (L // nb), (b + 1) * (L // nb))
    group = mesh.groups["map_block"]
    obs_s, obs_p, obs_w, X_b = obs_s[blk], obs_p[blk], obs_w[blk], X[blk]
    obs_n = None if obs_n is None else obs_n[blk]
    S = R.shape[0]
    for _ in range(iters):
        R, t, X_b, cost, nres = _ba_iteration(R, t, X_b, obs_s, obs_p, obs_w, S, damping,
                                              huber_delta=huber_delta, obs_n=obs_n,
                                              group=group)
    X = comm.all_gather_rows([X_b], group)[0]
    return BAResult(R=R, t=t, X=X, cost=cost, rms=torch.sqrt(cost / nres))
