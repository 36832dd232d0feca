"""Batched projector-camera triangulation (midpoint / ray-plane).

Port of ``slr/geom/triangulate.py``; the unfused oracle for the fused
kernel's geometry, the DLT least-squares triangulation, and the batched 3x3
solve of the two-camera splat oracle. All functions accept arbitrary extrinsics.
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


def triangulate_dlt(cam: Camera, proj: Camera, u, v, u_p, v_p=None):
    """DLT least-squares triangulation from undistorted pixel observations.

    The homogeneous system A X = 0 from the camera (2 rows) and the
    projector column (1 row; 2 with ``v_p``), solved for the inhomogeneous
    X through its 3x3 normal equations in closed form (no per-point SVD).
    """
    _, d_c = pixel_to_ray(cam, u, v)
    dc_cam = torch.einsum("ij,...j->...i", cam.R, d_c)   # the camera-frame ray
    xn_c = dc_cam[..., 0] / dc_cam[..., 2]
    yn_c = dc_cam[..., 1] / dc_cam[..., 2]

    def rows_for(camera, xn, yn, include_y=True):
        # P = [R | t]: (xn P3 - P1) X = -(xn t3 - t1), and so for y
        Rm, tm = camera.R, camera.t
        r1 = xn[..., None] * Rm[2] - Rm[0]
        b1 = -(xn * tm[2] - tm[0])
        if not include_y:
            return r1[..., None, :], b1[..., None]
        r2 = yn[..., None] * Rm[2] - Rm[1]
        b2 = -(yn * tm[2] - tm[1])
        return torch.stack([r1, r2], dim=-2), torch.stack([b1, b2], dim=-1)

    A_c, b_c = rows_for(cam, xn_c, yn_c)
    if v_p is None:
        xn_p = (u_p - proj.cx) / proj.fx
        A_p, b_p = rows_for(proj, xn_p, torch.zeros_like(xn_p), include_y=False)
    else:
        _, d_p = pixel_to_ray(proj, u_p, v_p)
        dp_proj = torch.einsum("ij,...j->...i", proj.R, d_p)
        A_p, b_p = rows_for(proj, dp_proj[..., 0] / dp_proj[..., 2],
                            dp_proj[..., 1] / dp_proj[..., 2])
    A = torch.cat([A_c, A_p], dim=-2)                    # (..., m, 3)
    b = torch.cat([b_c, b_p], dim=-1)                    # (..., m)
    AtA = torch.einsum("...mi,...mj->...ij", A, A)
    AtA = AtA + 1e-9 * torch.eye(3, dtype=AtA.dtype, device=AtA.device)
    return _solve3x3(AtA, torch.einsum("...mi,...m->...i", A, b))


def _solve3x3(A, b):
    """Batched closed-form 3x3 solve via the adjugate (Cramer):
    A (..., 3, 3), b (..., 3) -> x (..., 3)."""
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
    det = torch.where(det.abs() < 1e-18, 1e-18, det)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([(c00 * b0 + c01 * b1 + c02 * b2) / det,
                        (c10 * b0 + c11 * b1 + c12 * b2) / det,
                        (c20 * b0 + c21 * b1 + c22 * b2) / det], dim=-1)
