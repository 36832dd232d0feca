"""Projective-association ICP for organized scan clouds (port of
``slr/registration/projective.py``).

Scans are organized (H, W) grids, so a source point's correspondence is
found by moving it into the target rig frame, projecting it through the
target camera and reading the target's point and normal at that pixel:
O(N) gathers instead of a search.

On the card every call runs all its iterations in one launch of a kernel
written by hand (``kernels/csrc/icp.cu``, float32, counted as
``launches.icp_polish``); CPU tensors run ``icp_projective_reference``, the
kernel's plain version.
"""

from __future__ import annotations

import torch

from slr_torch.geom.camera import Camera, project
from slr_torch.geom.se3 import se3_compose, so3_exp
from slr_torch.kernels import icp as kernel
from slr_torch.registration.icp import ICPResult, _solve_point_to_plane


def icp_projective(
    src_pts,                 # (N,3) source points (source rig frame)
    src_valid,               # (N,) bool
    tgt_grid,                # (H,W,3) target organized cloud (target frame)
    tgt_mask,                # (H,W) bool
    tgt_normals,             # (H,W,3)
    cam: Camera,             # the rig camera (same intrinsics both scans)
    R0=None,
    t0=None,
    iters: int = 15,
    max_corr_dist: float = 10.0,
) -> ICPResult:
    """Align src -> tgt with per-iteration projective data association.
    (The reference's ``min_normal_cos`` is left out: it does not use it.)
    CUDA tensors launch the kernel once (float32; other dtypes raise
    ``ValueError``); CPU tensors run ``icp_projective_reference``."""
    if src_pts.device.type == "cuda":
        one = [None if x is None else x[None] for x in (src_valid, R0, t0)]
        return ICPResult(*(x[0] for x in kernel.polish(
            src_pts[None], one[0], tgt_grid[None], tgt_mask[None], tgt_normals[None], None,
            cam, one[1], one[2], iters=iters, max_corr_dist=max_corr_dist)))
    return icp_projective_reference(src_pts, src_valid, tgt_grid, tgt_mask, tgt_normals, cam,
                                    R0, t0, iters, max_corr_dist)


def icp_projective_reference(src_pts, src_valid, tgt_grid, tgt_mask, tgt_normals,
                             cam: Camera, R0=None, t0=None, iters: int = 15,
                             max_corr_dist: float = 10.0) -> ICPResult:
    """The plain version, on either device: ``icp_projective``'s loop."""
    H, W = tgt_mask.shape
    dev = src_pts.device
    R = torch.eye(3, device=dev) if R0 is None else R0
    t = torch.zeros(3, device=dev) if t0 is None else t0
    max_d2 = max_corr_dist * max_corr_dist
    n_valid = torch.sum(src_valid.to(torch.float32))
    for _ in range(iters):
        moved = src_pts @ R.T + t
        uv, z = project(cam, moved)
        ui = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 0, W - 1)
        vi = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 0, H - 1)
        in_img = ((uv[:, 0] >= 0) & (uv[:, 0] <= W - 1)
                  & (uv[:, 1] >= 0) & (uv[:, 1] <= H - 1) & (z > 0))
        q = tgt_grid[vi, ui]
        n = tgt_normals[vi, ui]
        ok = in_img & tgt_mask[vi, ui] & src_valid
        d2 = torch.sum((moved - q) ** 2, dim=1)
        w = (ok & (d2 < max_d2)).to(torch.float32)
        # robust reweighting, the same sort-free policy as the NN ICP
        abs_e = torch.abs(torch.sum((moved - q) * n, dim=1))
        mean_abs = torch.sum(w * abs_e) / torch.clamp(torch.sum(w), min=1e-9)
        delta = torch.clamp(1.3 * mean_abs, min=1e-6)
        w = w * torch.clamp(delta / torch.clamp(abs_e, min=1e-12), max=1.0)
        xi, e = _solve_point_to_plane(moved, q, n, w)
        R, t = se3_compose(so3_exp(xi[3:]), xi[:3], R, t)
        wsum = torch.sum(w)
        rms = torch.where(wsum > 1.0,
                          torch.sqrt(torch.sum(w * e * e) / torch.clamp(wsum, min=1e-9)),
                          float("inf"))
        inl = wsum / (n_valid + 1e-9)
    return ICPResult(R=R, t=t, rms=rms, inlier_frac=inl)
