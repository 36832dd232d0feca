"""Normalized-DLT homography estimation, board plane -> image (port of
``slr/calib/homography.py``), batched over views.

Hartley normalization, then the eigenvector of the smallest eigenvalue of
A^T A (a 9x9 ``eigh``, one batched call for every view).
"""

from __future__ import annotations

import math

import torch


def _similarity(scale, mean):
    """(..., 3, 3) [[s, 0, -s mx], [0, s, -s my], [0, 0, 1]]."""
    z, o = torch.zeros_like(scale), torch.ones_like(scale)
    return torch.stack([torch.stack([scale, z, -scale * mean[..., 0]], -1),
                        torch.stack([z, scale, -scale * mean[..., 1]], -1),
                        torch.stack([z, z, o], -1)], -2)


def _normalize_points(pts):
    """(..., N, 2): centroid to 0, mean distance to sqrt(2). Returns the
    moved points and the (..., 3, 3) similarity."""
    mean = pts.mean(dim=-2)
    centered = pts - mean[..., None, :]
    scale = math.sqrt(2.0) / (torch.linalg.norm(centered, dim=-1).mean(dim=-1) + 1e-12)
    return centered * scale[..., None, None], _similarity(scale, mean)


def homography_dlt(obj_xy, img_uv):
    """obj_xy (..., N, 2) board-plane coords, img_uv (..., N, 2) pixels ->
    H (..., 3, 3), normalized so H[2, 2] == 1. Leading dims broadcast: one
    batched solve for every view."""
    obj_xy, img_uv = torch.broadcast_tensors(obj_xy.to(torch.float32),
                                             img_uv.to(torch.float32))
    src, Ts = _normalize_points(obj_xy)
    dst, Td = _normalize_points(img_uv)
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    # rows: [-x,-y,-1, 0,0,0, ux,uy,u] and [0,0,0, -x,-y,-1, vx,vy,v]
    r1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], dim=-1)
    r2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    _, V = torch.linalg.eigh(A.mT @ A)
    Hn = V[..., :, 0].reshape(*V.shape[:-2], 3, 3)   # smallest eigenvalue's
    H, _ = torch.linalg.solve_ex(Td, Hn @ Ts)
    return H / H[..., 2:3, 2:3]
