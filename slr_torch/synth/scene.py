"""Synthetic scenes: camera-frame depth maps (port of ``slr/synth/scene.py``).

Ported so far: ``bumps_depth`` (the config-3 scene), ``checker_albedo``
(the HDR bracket's texture), and the closed-form world scenes that render
from any rig pose, ``plane_depth``, ``sphere_depth``, ``spheres_scene``
(the two-camera scene) and ``rocks_scene`` (the config-4 registration
scene). The rest of ``slr.synth`` is ROADMAP
slice 10.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slr_torch.geom.camera import Camera, pixel_to_ray


def _pixel_rays(cam: Camera, h: int, w: int):
    """(origin (3,), unit world-frame directions (h, w, 3)) of every pixel."""
    dev = cam.R.device
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    return pixel_to_ray(cam, u, v)


def _cam_depth(cam: Camera, pts):
    """World points -> depth along the camera z axis."""
    return torch.einsum("j,...j->...", cam.R[2], pts) + cam.t[2]


def plane_depth(cam: Camera, h: int, w: int, point, normal):
    """Depth map (h, w) of the plane through ``point`` with ``normal``
    (world frame), as seen by ``cam`` (any extrinsics)."""
    o, d = _pixel_rays(cam, h, w)
    point = torch.as_tensor(point, dtype=torch.float32).to(o.device)
    normal = torch.as_tensor(normal, dtype=torch.float32).to(o.device)
    denom = torch.einsum("...i,i->...", d, normal)
    denom = torch.where(denom.abs() < 1e-9, 1e-9, denom)
    lam = torch.einsum("...i,i->...", point - o, normal) / denom
    return _cam_depth(cam, o + lam[..., None] * d)


def sphere_depth(cam: Camera, h: int, w: int, center, radius, background=None):
    """Depth of a sphere seen by ``cam`` (any extrinsics); pixels missing
    it take ``background`` (a constant camera-frame depth)."""
    o, d = _pixel_rays(cam, h, w)
    c = torch.as_tensor(center, dtype=torch.float32).to(o.device)
    oc = o - c
    b = torch.einsum("...i,i->...", d, oc)
    cc = torch.einsum("...i,...i->...", oc, oc) - radius * radius
    disc = b * b - cc
    hit = disc > 0
    lam = -b - torch.sqrt(torch.where(hit, disc, 0.0))
    z = _cam_depth(cam, o + lam[..., None] * d)
    if background is None:
        background = float(center[2]) + 4.0 * radius
    return torch.where(hit & (lam > 0), z, float(background))


def spheres_scene(cam: Camera, h: int, w: int, plane_point=(0, 0, 560.0),
                  plane_normal=(0.15, 0.1, -1.0), spheres=None):
    """Tilted plane and three unequal spheres (min depth): an asymmetric
    world scene, re-renderable from any rig pose."""
    if spheres is None:
        spheres = (((20.0, 5.0, 540.0), 140.0),
                   ((-60.0, -40.0, 520.0), 60.0),
                   ((70.0, 50.0, 530.0), 45.0))
    depth = plane_depth(cam, h, w, plane_point, plane_normal)
    for center, radius in spheres:
        depth = torch.minimum(depth, sphere_depth(cam, h, w, center, radius,
                                                  background=1e6))
    return depth


def rocks_scene(cam: Camera, h: int, w: int, n: int = 18, seed: int = 0,
                plane_point=(0, 0, 580.0), plane_normal=(0.12, 0.08, -1.0)):
    """World-anchored "rock field": n unequal spheres over a tilted plane,
    from numpy's generator seeded ``seed`` (the reference's draw). The
    spread of radii makes local curvature, and so FPFH, discriminative."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-120, 120, n)
    ys = rng.uniform(-80, 80, n)
    rs = rng.uniform(14.0, 42.0, n)
    # each rock half-embedded in the plane region around z ~ 545
    zs = 565.0 - 0.35 * rs + rng.uniform(-12, 12, n)
    depth = plane_depth(cam, h, w, plane_point, plane_normal)
    for x, y, z, r in zip(xs, ys, zs, rs):
        depth = torch.minimum(depth, sphere_depth(
            cam, h, w, (float(x), float(y), float(z)), float(r), background=1e6))
    return depth


def _linspace01(n: int, device):
    # jnp.linspace(0, 1, n) in float32: iota / (n - 1), bit for bit
    return torch.arange(n, dtype=torch.float32, device=device) / (n - 1)


def bumps_depth(h: int, w: int, base: float = 500.0, amp: float = 30.0,
                freq: float = 3.0, device="cpu"):
    """Smooth Gaussian-bump height field as a direct depth map (h, w)."""
    v = _linspace01(h, device)[:, None]
    u = _linspace01(w, device)[None, :]
    z = base + amp * (
        torch.sin(2 * math.pi * freq * u) * torch.cos(2 * math.pi * freq * v)
        + 0.5 * torch.exp(-(((u - 0.5) ** 2 + (v - 0.5) ** 2) / 0.02))
    )
    return z.to(torch.float32)


def checker_albedo(h: int, w: int, cells: int = 8, lo: float = 0.4,
                   hi: float = 1.0, device="cpu"):
    """Checkerboard albedo (h, w) to exercise texture-dependent modulation."""
    v = torch.arange(h, device=device)[:, None]
    u = torch.arange(w, device=device)[None, :]
    c = ((u * cells // w) + (v * cells // h)) % 2
    return torch.where(c == 0, lo, hi).to(torch.float32)
