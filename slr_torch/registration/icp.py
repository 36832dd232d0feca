"""Point-to-plane ICP (port of ``slr/registration/icp.py``).

Each iteration: move the source by the current pose, find each point's
nearest target (the tiled exact search, the voxel hash, or the sorted-band
search K8),
gate correspondences by distance, reweight them (Huber), and take one
closed-form 6-dof Gauss-Newton step from the 6x6 normal equations.

On the card, every call on the exact route (``kernels/icp.py::
takes_kernel``) runs every iteration in one launch of a kernel written by
hand (``kernels/csrc/icp.cu``, float32, counted as ``launches.icp``).
CPU tensors, and the voxel and band routes, run
``icp_point_to_plane_reference``, the kernel's plain version: a Python
loop with no host sync inside (the 6x6 system solved by ``cholesky_ex`` and
``cholesky_solve``, which check nothing on the host).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slr_torch.geom.se3 import se3_compose, so3_exp
from slr_torch.kernels import icp as kernel
from slr_torch.registration.band import BIG, band_nn_sorted, build_band_target
from slr_torch.registration.nn import nearest_neighbors
from slr_torch.registration.voxel import build_voxel_hash, voxel_hash_nn


class ICPResult(NamedTuple):
    R: torch.Tensor            # (3,3) source -> target rotation
    t: torch.Tensor            # (3,)
    rms: torch.Tensor          # final inlier point-to-plane RMS
    inlier_frac: torch.Tensor


def _solve_point_to_plane(src, tgt, nrm, w):
    """One GN step: minimise sum w ((R src + t - tgt) . n)^2, small angle.

    Returns (xi (6,) = [tau, omega], residuals). A_i = [n, src x n].
    """
    e = torch.sum((src - tgt) * nrm, dim=1)
    A = torch.cat([nrm, torch.cross(src, nrm, dim=1)], dim=1)   # (N,6)
    Aw = A * w[:, None]
    H = Aw.T @ A + 1e-6 * torch.eye(6, device=A.device)
    g = Aw.T @ e
    L, _ = torch.linalg.cholesky_ex(H)
    return -torch.cholesky_solve(g[:, None], L)[:, 0], e


# Above this many query x target pairs the exact tiled search gives way to
# the voxel hash on the CPU and to the sorted-band search on the card (the
# reference's CPU and accelerator crossovers).
_EXACT_NN_MAX_PAIRS = 24_000 ** 2
NN_METHODS = ("exact", "voxel", "band")


def _resolve_nn_method(nn_method: str, N: int, M: int, device) -> str:
    """"auto": exact up to the crossover; above it the voxel hash for a CPU
    tensor and the band search (K8) for a CUDA one, the reference's CPU and
    accelerator rules."""
    if nn_method == "auto":
        if N * M <= _EXACT_NN_MAX_PAIRS:
            return "exact"
        return "voxel" if torch.device(device).type == "cpu" else "band"
    if nn_method not in NN_METHODS:
        raise ValueError(f"nn_method must be 'auto' or one of {NN_METHODS}, "
                         f"got {nn_method!r}")
    return nn_method


def icp_point_to_plane(
    src,                     # (N,3) source points
    tgt,                     # (M,3) target points
    tgt_normals,             # (M,3)
    src_valid=None,          # (N,) bool
    tgt_valid=None,          # (M,) bool
    R0=None,
    t0=None,
    iters: int = 20,
    max_corr_dist: float = 10.0,
    nn_tile: int = 2048,
    nn_method: str = "auto",
    band_b_max: int | None = None,
) -> ICPResult:
    """Align ``src`` onto ``tgt``; returns the source -> target pose.

    ``nn_method``: "exact" (tiled brute force), "voxel" (the voxel hash's
    27-neighbourhood, voxel edge ``max_corr_dist``), "band" (sorted-band
    search, exact within ``max_corr_dist``: K8 on a CUDA tensor) or "auto"
    (exact up to ~24k^2 source x target pairs; above, voxel on the CPU and
    band on the card; resolved from the tensors' sizes and device on every
    call). ``band_b_max`` is accepted for signature parity and ignored: the
    band search never truncates. On the card the exact route runs in one
    launch (float32; other dtypes raise ``ValueError``), every other call
    ``icp_point_to_plane_reference``.

    The band route builds the sorted target once and sorts the source once
    by its key at the initial pose; the Gauss-Newton sums do not depend on
    the order, so nothing is unsorted, and each iteration takes the
    correspondence point and normal straight from the search.
    """
    nn_method = _resolve_nn_method(nn_method, src.shape[0], tgt.shape[0], src.device)
    if kernel.takes_kernel(src.shape[0], tgt.shape[0], src.device, nn_method):
        one = [None if x is None else x[None] for x in (src_valid, tgt_valid, R0, t0)]
        return ICPResult(*(x[0] for x in kernel.align(
            src[None], tgt[None], tgt_normals[None], *one, iters=iters,
            max_corr_dist=max_corr_dist)))
    return icp_point_to_plane_reference(src, tgt, tgt_normals, src_valid, tgt_valid, R0, t0,
                                        iters, max_corr_dist, nn_tile, nn_method)


def icp_point_to_plane_reference(src, tgt, tgt_normals, src_valid=None, tgt_valid=None,
                                 R0=None, t0=None, iters: int = 20,
                                 max_corr_dist: float = 10.0, nn_tile: int = 2048,
                                 nn_method: str = "auto") -> ICPResult:
    """The plain version, on either device: ``icp_point_to_plane``'s loop,
    each iteration's search by ``nn_method`` ("auto" resolved as there)."""
    nn_method = _resolve_nn_method(nn_method, src.shape[0], tgt.shape[0], src.device)
    dev = src.device
    N = src.shape[0]
    if src_valid is None:
        src_valid = torch.ones(N, dtype=torch.bool, device=dev)
    R = torch.eye(3, device=dev) if R0 is None else R0.to(torch.float32)
    t = torch.zeros(3, device=dev) if t0 is None else t0.to(torch.float32)
    max_d2 = max_corr_dist * max_corr_dist

    if nn_method == "band":
        bt = build_band_target(tgt, tgt_normals, tgt_valid)
        skey = torch.where(src_valid, (src @ R.T + t) @ bt.axis, 1e38)
        order = torch.sort(skey, stable=True).indices
        src = src[order]
        src_valid = src_valid[order]
    elif nn_method == "voxel":
        # voxel edge = correspondence radius: every target within
        # max_corr_dist lies in the query's 27-neighbourhood
        tv = (torch.ones(tgt.shape[0], dtype=torch.bool, device=dev)
              if tgt_valid is None else tgt_valid)
        table, row_ids, lo = build_voxel_hash(tgt, tv, max_corr_dist)

    n_valid = torch.sum(src_valid.to(torch.float32))
    for _ in range(iters):
        moved = src @ R.T + t
        if nn_method == "band":
            d2, q, n, _ = band_nn_sorted(
                torch.where(src_valid[:, None], moved, BIG).T.contiguous(),
                src_valid, bt, max_corr_dist)
        else:
            if nn_method == "voxel":
                idx, d2 = voxel_hash_nn(moved, tgt, table, row_ids, lo, max_corr_dist)
                idx = idx.clamp(min=0)   # a miss carries d2 = inf (gated)
            else:
                idx, d2 = nearest_neighbors(moved, tgt, tgt_valid, tile=nn_tile)
            q, n = tgt[idx], tgt_normals[idx]
        w = (src_valid & (d2 < max_d2)).to(torch.float32)
        # robust (Huber/IRLS) reweighting; delta = 1.3 x the weighted mean
        # |e|, the 70th percentile of Gaussian residuals without a sort
        abs_e = torch.abs(torch.sum((moved - q) * n, dim=1))
        mean_abs = torch.sum(w * abs_e) / torch.clamp(torch.sum(w), min=1e-9)
        delta = torch.clamp(1.3 * mean_abs, min=1e-6)
        w = w * torch.clamp(delta / torch.clamp(abs_e, min=1e-12), max=1.0)
        xi, e = _solve_point_to_plane(moved, q, n, w)
        # update: p -> dR p + dt applied after the current pose
        R, t = se3_compose(so3_exp(xi[3:]), xi[:3], R, t)
        wsum = torch.sum(w)
        # no surviving correspondences = divergence, not a perfect fit
        rms = torch.where(wsum > 1.0,
                          torch.sqrt(torch.sum(w * e * e) / torch.clamp(wsum, min=1e-9)),
                          float("inf"))
        inl = wsum / (n_valid + 1e-9)
    return ICPResult(R=R, t=t, rms=rms, inlier_frac=inl)
