"""Batched projector-camera triangulation (midpoint / ray-plane).

Port of ``slr/geom/triangulate.py``; the unfused oracle for the fused
kernel's geometry. All functions accept arbitrary extrinsics.
"""

from __future__ import annotations

import torch

from slr_torch.geom.camera import Camera, pixel_to_ray


def triangulate_midpoint(o1, d1, o2, d2):
    """Midpoint of the common perpendicular of two ray bundles.

    o1,o2: (3,) or (...,3) origins; d1,d2: (...,3) unit directions.
    Returns (points (...,3), gap (...,) distance between the two rays).
    """
    r = o1 - o2
    a = torch.sum(d1 * d1, dim=-1)
    b = torch.sum(d1 * d2, dim=-1)
    c = torch.sum(d2 * d2, dim=-1)
    d = torch.sum(d1 * r, dim=-1)
    e = torch.sum(d2 * r, dim=-1)
    denom = a * c - b * b
    denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    s = (b * e - c * d) / denom
    t = (a * e - b * d) / denom
    p1 = o1 + s[..., None] * d1
    p2 = o2 + t[..., None] * d2
    mid = 0.5 * (p1 + p2)
    gap = torch.linalg.norm(p1 - p2, dim=-1)
    return mid, gap


def triangulate_plane(cam: Camera, proj: Camera, u, v, x_p):
    """Column-only coding: intersect camera rays with projector column planes.

    The plane holds the projector center and the line x = x_p on the
    projector image plane; its normal in projector coords is
    (1, 0, -xn_p) with xn_p = (x_p - cx)/fx. Projector lens distortion is
    neglected. Returns (points (...,3) in world frame, depth along camera z).
    """
    o_c, d_c = pixel_to_ray(cam, u, v)
    xn_p = (x_p - proj.cx) / proj.fx
    n_p = torch.stack([torch.ones_like(xn_p), torch.zeros_like(xn_p), -xn_p],
                      dim=-1)
    n_w = torch.einsum("ji,...j->...i", proj.R, n_p)
    c_p = proj.center
    denom = torch.sum(n_w * d_c, dim=-1)
    denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    lam = torch.sum(n_w * (c_p - o_c), dim=-1) / denom
    pts = o_c + lam[..., None] * d_c
    depth = torch.einsum("j,...j->...", cam.R[2], pts) + cam.t[2]
    return pts, depth


def triangulate_rays(cam: Camera, proj: Camera, u, v, u_p, v_p):
    """Row+column coding: midpoint triangulation of camera + projector rays."""
    o_c, d_c = pixel_to_ray(cam, u, v)
    o_p, d_p = pixel_to_ray(proj, u_p, v_p)
    return triangulate_midpoint(o_c, d_c, o_p, d_p)
