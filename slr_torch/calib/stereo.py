"""Projector calibration and joint camera-projector stereo refinement (port
of ``slr/calib/stereo.py``).

The projector is calibrated as an inverse camera: decoding gives each board
corner's projector coordinate, which feeds the same Zhang solve. The stereo
stage then refines both intrinsic sets, the fixed camera -> projector pose
and every board pose jointly.

``calib_result_to_numpy`` and ``calib_result_from_numpy`` carry a
``CalibrationResult`` or ``StereoResult`` across to numpy fields (the
layout of the JAX package's results after ``jax.tree.map(np.asarray, r)``)
and back.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slr_torch.calib.lm import lm_solve
from slr_torch.calib.zhang import CalibrationResult, _reproject, calibrate_camera
from slr_torch.geom.camera import Camera, camera_from_numpy, make_camera
from slr_torch.geom.se3 import se3_compose, so3_exp, so3_log


def calibrate_projector(obj, proj_uv_views, lm_iters: int = 60):
    """Zhang solve with the projector as an inverse camera.

    proj_uv_views (V,N,2): decoded projector coordinates of board corners."""
    return calibrate_camera(obj, proj_uv_views, lm_iters=lm_iters)


class StereoResult(NamedTuple):
    cam: Camera             # refined camera intrinsics (R=I, t=0)
    proj: Camera            # refined projector intrinsics + world->proj R,t
    rvecs: torch.Tensor     # (V,3) refined board poses (world=camera frame)
    tvecs: torch.Tensor
    rms: torch.Tensor       # joint reprojection RMS, px


def _pack_intr(cam: Camera):
    return torch.cat([torch.stack([cam.fx / 100.0, cam.fy / 100.0, cam.cx, cam.cy]),
                      cam.dist])


def _unpack_intr(p):
    return p[0] * 100.0, p[1] * 100.0, p[2], p[3], p[4:9]


def _stereo_residual(params, obj, cam_uv, proj_uv, n_views):
    pose = params[24:].reshape(n_views, 6)
    R, t = so3_exp(pose[:, :3]), pose[:, 3:]
    rc = _reproject(*_unpack_intr(params[0:9]), R, t, obj) - cam_uv
    Rp, tp = se3_compose(so3_exp(params[18:21]), params[21:24], R, t)
    rp = _reproject(*_unpack_intr(params[9:18]), Rp, tp, obj) - proj_uv
    return torch.cat([rc, rp], dim=1).reshape(-1)


def stereo_calibrate(
    obj,
    cam_uv,                  # (V,N,2) camera corner detections
    proj_uv,                 # (V,N,2) decoded projector corner coords
    cam_init: CalibrationResult,
    proj_init: CalibrationResult,
    lm_iters: int = 80,
) -> StereoResult:
    V = cam_uv.shape[0]
    # initial relative pose: the mean over views of T_proj_view o inv(T_cam_view)
    Rc = so3_exp(cam_init.rvecs)
    Rp = so3_exp(proj_init.rvecs)
    R_rel_views = Rp @ Rc.mT
    t_rel_views = proj_init.tvecs - (R_rel_views @ cam_init.tvecs[..., None])[..., 0]
    # chordal-mean rotation: SVD projection of the mean matrix
    U, _, Vh = torch.linalg.svd(R_rel_views.mean(dim=0))
    R_rel0 = U @ Vh
    R_rel0 = R_rel0 * torch.sign(torch.linalg.det(R_rel0))
    rel0 = torch.cat([so3_log(R_rel0), t_rel_views.mean(dim=0)])
    x0 = torch.cat([_pack_intr(cam_init.camera), _pack_intr(proj_init.camera), rel0,
                    torch.cat([cam_init.rvecs, cam_init.tvecs], dim=1).reshape(-1)])
    x, cost = lm_solve(_stereo_residual, x0, args=(obj, cam_uv, proj_uv, V), iters=lm_iters)
    pose = x[24:].reshape(V, 6)
    rms = torch.sqrt(cost / ((cam_uv.numel() + proj_uv.numel()) / 2.0))
    fxc, fyc, cxc, cyc, dc = _unpack_intr(x[0:9])
    fxp, fyp, cxp, cyp, dp = _unpack_intr(x[9:18])
    return StereoResult(
        cam=make_camera(fxc, fyc, cxc, cyc, dist=dc, device=x.device),
        proj=make_camera(fxp, fyp, cxp, cyp, dist=dp, R=so3_exp(x[18:21]), t=x[21:24],
                         device=x.device),
        rvecs=pose[:, :3], tvecs=pose[:, 3:], rms=rms)


def calib_result_to_numpy(res):
    """A port ``CalibrationResult`` or ``StereoResult`` -> the same result
    with float32 numpy fields (cameras as ``Camera`` of numpy arrays): the
    JAX result's layout after ``jax.tree.map(np.asarray, r)``."""
    def conv(x):
        if isinstance(x, tuple):
            return type(x)(*(conv(v) for v in x))
        return x.detach().cpu().numpy()
    return conv(res)


def calib_result_from_numpy(res_np, device="cpu"):
    """A result with numpy (or JAX) fields, either package's
    ``CalibrationResult`` or ``StereoResult`` -> the port's, on
    ``device``."""
    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    if "camera" in res_np._fields:
        return CalibrationResult(camera_from_numpy(res_np.camera, device),
                                 *(f32(x) for x in res_np[1:]))
    return StereoResult(camera_from_numpy(res_np.cam, device),
                        camera_from_numpy(res_np.proj, device),
                        *(f32(x) for x in res_np[2:]))
