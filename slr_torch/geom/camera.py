"""Pinhole + Brown-Conrady distortion camera/projector model.

Port of ``slr/geom/camera.py``. One model serves both the camera and the
projector. A camera is ``Camera(fx, fy, cx, cy, dist, R, t)``, a
NamedTuple of float32 tensors, where ``(R, t)`` maps *world* points into
*camera* coordinates: ``x_cam = R @ X + t``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Camera(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor  # (5,) k1 k2 p1 p2 k3
    R: torch.Tensor     # (3,3) world->cam rotation
    t: torch.Tensor     # (3,)  world->cam translation

    def to(self, device) -> "Camera":
        return Camera(*(x.to(device) for x in self))

    @property
    def center(self):
        """Camera center in world coordinates: -R^T t."""
        return -torch.einsum("...ji,...j->...i", self.R, self.t)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def make_camera(fx, fy, cx, cy, dist=None, R=None, t=None,
                device="cpu") -> Camera:
    """Every field is cast to float32, as ``slr.geom.camera.make_camera``."""
    dist = torch.zeros(5) if dist is None else _f32(dist, device)
    dist = (torch.nn.functional.pad(dist, (0, 5 - dist.shape[0]))
            if dist.shape[0] < 5 else dist[:5])
    R = torch.eye(3) if R is None else R
    t = torch.zeros(3) if t is None else t
    return Camera(*(_f32(x, device) for x in (fx, fy, cx, cy, dist, R, t)))


def camera_from_numpy(cam_np, device="cpu") -> Camera:
    """A camera given as seven numpy arrays (the JAX ``Camera`` after
    ``jax.tree.map(np.asarray, cam)``) -> the port's ``Camera``. This is
    how calibration state crosses from the reference to the port."""
    return Camera(*(_f32(np.array(x, np.float32), device) for x in cam_np))


def distort(xn, yn, dist):
    """Apply Brown-Conrady distortion to normalized coords. Broadcasts."""
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xy = xn * yn
    xd = xn * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xy
    return xd, yd


def undistort_iterative(xd, yd, dist, iters: int = 8):
    """Invert the distortion by fixed-point iteration (cv2-style)."""
    xn, yn = xd, yd
    for _ in range(iters):
        xdd, ydd = distort(xn, yn, dist)
        xn, yn = xn + (xd - xdd), yn + (yd - ydd)
    return xn, yn


def project(cam: Camera, pts_world):
    """World points (...,3) -> pixel coords (...,2) and camera-frame depth."""
    pc = torch.einsum("ij,...j->...i", cam.R, pts_world) + cam.t
    z = pc[..., 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    xn, yn = pc[..., 0] / zs, pc[..., 1] / zs
    xd, yd = distort(xn, yn, cam.dist)
    u = cam.fx * xd + cam.cx
    v = cam.fy * yd + cam.cy
    return torch.stack([u, v], dim=-1), z


def pixel_to_ray(cam: Camera, u, v, undistort_iters: int = 8):
    """Pixel coords -> unit ray direction in *world* frame + origin.

    Returns (origin (3,), dirs (...,3)).
    """
    xd = (u - cam.cx) / cam.fx
    yd = (v - cam.cy) / cam.fy
    xn, yn = undistort_iterative(xd, yd, cam.dist, undistort_iters)
    d_cam = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)
    d_world = torch.einsum("ji,...j->...i", cam.R, d_cam)  # R^T d
    d_world = d_world / torch.linalg.norm(d_world, dim=-1, keepdim=True)
    return cam.center, d_world
