"""Zhang calibration: closed-form initialisation and batched LM refinement
(port of ``slr/calib/zhang.py``).

Closed form: the B = K^-T K^-1 constraints of >= 3 homographies give the
intrinsics; the extrinsics follow per view; distortion starts at 0. Then
one LM solve over {fx, fy, cx, cy, k1, k2, p1, p2, k3, (rvec_i, tvec_i)}
minimizing the reprojection error of every corner in every view, all views
at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slr_torch.calib.homography import homography_dlt
from slr_torch.calib.lm import lm_solve
from slr_torch.geom.camera import Camera, distort, make_camera
from slr_torch.geom.se3 import so3_exp, so3_log


class CalibrationResult(NamedTuple):
    camera: Camera          # intrinsics + distortion (R=I, t=0)
    rvecs: torch.Tensor     # (V,3) per-view board rotations
    tvecs: torch.Tensor     # (V,3)
    rms: torch.Tensor       # reprojection RMS in px


def _v_ij(H, i, j):
    """(..., 6) Zhang's v_ij of homographies (..., 3, 3)."""
    return torch.stack([
        H[..., 0, i] * H[..., 0, j],
        H[..., 0, i] * H[..., 1, j] + H[..., 1, i] * H[..., 0, j],
        H[..., 1, i] * H[..., 1, j],
        H[..., 2, i] * H[..., 0, j] + H[..., 0, i] * H[..., 2, j],
        H[..., 2, i] * H[..., 1, j] + H[..., 1, i] * H[..., 2, j],
        H[..., 2, i] * H[..., 2, j],
    ], dim=-1)


def zhang_init_intrinsics(Hs):
    """Closed-form (fx, fy, cx, cy) from stacked homographies (V,3,3), V >= 3
    (skew dropped): two rows of constraints a view, one 6x6 ``eigh``."""
    V = torch.stack([_v_ij(Hs, 0, 1), _v_ij(Hs, 0, 0) - _v_ij(Hs, 1, 1)],
                    dim=1).reshape(-1, 6)
    _, evecs = torch.linalg.eigh(V.T @ V)
    B11, B12, B22, B13, B23, B33 = evecs[:, 0]
    v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 * B12)
    lam = B33 - (B13 * B13 + v0 * (B12 * B13 - B11 * B23)) / B11
    alpha = torch.sqrt(torch.abs(lam / B11))
    beta = torch.sqrt(torch.abs(lam * B11 / (B11 * B22 - B12 * B12)))
    gamma = -B12 * alpha * alpha * beta / lam
    u0 = gamma * v0 / beta - B13 * alpha * alpha / lam
    return alpha, beta, u0, v0  # fx, fy, cx, cy


def _nearest_rotation(M):
    U, _, Vh = torch.linalg.svd(M)
    return U @ Vh


def extrinsics_from_homography(H, fx, fy, cx, cy):
    """Per-view (rvec, tvec) from H (..., 3, 3) and K (Zhang), the rotation
    taken as the nearest orthogonal matrix (SVD), the board in front."""
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    Kinv = torch.stack([torch.stack([1.0 / fx, z, -cx / fx]),
                        torch.stack([z, 1.0 / fy, -cy / fy]),
                        torch.stack([z, z, o])])
    KH = Kinv @ H
    h1, h2, h3 = KH[..., :, 0], KH[..., :, 1], KH[..., :, 2]
    lam = 1.0 / (torch.linalg.norm(h1, dim=-1, keepdim=True) + 1e-12)
    t = lam * h3
    # board in front of the camera; flipping t flips r1, r2 too (H is
    # defined up to sign)
    flip = torch.sign(t[..., 2:3])
    r1, r2 = lam * h1 * flip, lam * h2 * flip
    Rf = torch.stack([r1, r2, torch.linalg.cross(r1, r2)], dim=-1)
    return so3_log(_nearest_rotation(Rf)), t * flip


def _reproject(fx, fy, cx, cy, dist, R, t, obj):
    """Board points obj (N,3) through poses R (V,3,3), t (V,3) into pixels
    (V, N, 2)."""
    pc = obj @ R.mT + t[:, None, :]
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    xd, yd = distort(pc[..., 0] / zs, pc[..., 1] / zs, dist)
    return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)


def _project_residual(params, obj, img, n_views):
    """Packed params -> reprojection residual vector.

    params: [fx', fy', cx, cy, d0..d4, (rvec,tvec)*V], focals stored /100
    to balance the Jacobian columns in float32."""
    pose = params[9:].reshape(n_views, 6)
    uv = _reproject(params[0] * 100.0, params[1] * 100.0, params[2], params[3],
                    params[4:9], so3_exp(pose[:, :3]), pose[:, 3:], obj)
    return (uv - img).reshape(-1)


def calibrate_camera(obj, img_views, lm_iters: int = 60) -> CalibrationResult:
    """obj (N,3) board points (z=0), img_views (V,N,2) detected corners, on
    one device: batched DLT homographies -> closed-form intrinsics -> per-view
    extrinsics -> joint LM."""
    obj = obj.to(torch.float32)
    img_views = img_views.to(torch.float32)
    V = img_views.shape[0]
    Hs = homography_dlt(obj[:, :2], img_views)
    fx, fy, cx, cy = zhang_init_intrinsics(Hs)
    rv, tv = extrinsics_from_homography(Hs, fx, fy, cx, cy)
    x0 = torch.cat([torch.stack([fx / 100.0, fy / 100.0, cx, cy]),
                    torch.zeros(5, device=obj.device),
                    torch.cat([rv, tv], dim=1).reshape(-1)])
    x, cost = lm_solve(_project_residual, x0, args=(obj, img_views, V), iters=lm_iters)
    # per-point Euclidean RMS in px (cv2.calibrateCamera convention)
    rms = torch.sqrt(cost / (img_views.numel() / 2.0))
    pose = x[9:].reshape(V, 6)
    cam = make_camera(x[0] * 100.0, x[1] * 100.0, x[2], x[3], dist=x[4:9],
                      device=obj.device)
    return CalibrationResult(camera=cam, rvecs=pose[:, :3], tvecs=pose[:, 3:], rms=rms)
