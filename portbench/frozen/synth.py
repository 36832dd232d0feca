"""The benchmark's frozen copy of the synthetic scanner: the rig, the
config-3 scene (``bumps_depth``), config 5's rock field and orbit, and the
pattern renderer, restricted to what the benchmark's configurations use
(column Gray code with inverses, an N-step phase shift, no optics).

Copied from ``slr_torch/synth/render.py``, ``slr_torch/synth/scene.py``,
``slr_torch/geom/camera.py``, ``slr_torch/geom/se3.py::so3_exp`` and
``slr_torch/codec/{graycode,phaseshift,patterns}.py``, operation for
operation, so that it renders the same bits; the orbit is
``chip_smoke.py::render_orbit``'s. It imports nothing of the program: a
later change to the program's synth cannot move the benchmark's inputs.
``portbench/tests/test_portbench_synth.py`` holds it to the program's
synth as the two stand today.

A camera here is ``Cam(fx, fy, cx, cy, dist, R, t)`` of float32 tensors,
field for field the program's ``Camera``; ``(R, t)`` maps world points
into the camera frame.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

TWO_PI = 2.0 * math.pi


class Cam(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor   # (5,) k1 k2 p1 p2 k3
    R: torch.Tensor      # (3, 3) world -> camera
    t: torch.Tensor      # (3,)

    def to(self, device) -> "Cam":
        return Cam(*(x.to(device) for x in self))

    @property
    def center(self):
        return -torch.einsum("...ji,...j->...i", self.R, self.t)


class Rendered(NamedTuple):
    frames: torch.Tensor       # (F, H, W) in [0, 1]
    points_true: torch.Tensor  # (H, W, 3) world frame
    mask_true: torch.Tensor    # (H, W) lit by the projector


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def make_cam(fx, fy, cx, cy, R=None, t=None, device="cpu") -> Cam:
    R = torch.eye(3) if R is None else R
    t = torch.zeros(3) if t is None else t
    return Cam(*(_f32(x, device) for x in (fx, fy, cx, cy, torch.zeros(5), R, t)))


def _toed_in(cx_world: float, deg: float):
    th = torch.deg2rad(torch.tensor(deg, dtype=torch.float32))
    c, s = torch.cos(th), torch.sin(th)
    z, o = torch.zeros(()), torch.ones(())
    R = torch.stack([torch.stack([c, z, s]), torch.stack([z, o, z]),
                     torch.stack([-s, z, c])])
    return R, -R @ torch.tensor([cx_world, 0.0, 0.0])


def default_rig(cam_w: int = 1280, cam_h: int = 1024, proj_w: int = 1024,
                proj_h: int = 768, baseline: float = 200.0,
                toe_in_deg: float = 12.0, device="cpu"):
    """Camera at the origin, projector at x = +baseline toed in about y."""
    f_c = 0.9 * cam_w
    cam = make_cam(f_c, f_c, cam_w / 2 - 0.5, cam_h / 2 - 0.5, device=device)
    R, t = _toed_in(baseline, toe_in_deg)
    f_p = 1.2 * proj_w
    proj = make_cam(f_p, f_p, proj_w / 2 - 0.5, proj_h / 2 - 0.5, R=R, t=t,
                    device=device)
    return cam, proj


def move_rig(cam: Cam, proj: Cam, R_m, t_m):
    """The rig moved by (R_m, t_m), rig -> world."""
    R_m = torch.as_tensor(R_m, dtype=torch.float32).to(cam.R.device)
    t_m = torch.as_tensor(t_m, dtype=torch.float32).to(cam.R.device)

    def mv(c: Cam) -> Cam:
        R_new = c.R @ R_m.T
        return c._replace(R=R_new, t=c.t - R_new @ t_m)

    return mv(cam), mv(proj)


def so3_exp(phi):
    """Rodrigues: (3,) rotation vector -> (3, 3) rotation."""
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2 + 1e-8 * 1e-8)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    wx, wy, wz = phi[..., 0], phi[..., 1], phi[..., 2]
    zeros = torch.zeros_like(wx)
    K = torch.stack([torch.stack([zeros, -wz, wy], dim=-1),
                     torch.stack([wz, zeros, -wx], dim=-1),
                     torch.stack([-wy, wx, zeros], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)
    return eye + a * K + b * (K @ K)


def _distort(xn, yn, dist):
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xy = xn * yn
    xd = xn * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xy
    return xd, yd


def _undistort(xd, yd, dist, iters: int = 8):
    xn, yn = xd, yd
    for _ in range(iters):
        xdd, ydd = _distort(xn, yn, dist)
        xn, yn = xn + (xd - xdd), yn + (yd - ydd)
    return xn, yn


def project(cam: Cam, pts_world):
    pc = torch.einsum("ij,...j->...i", cam.R, pts_world) + cam.t
    z = pc[..., 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    xd, yd = _distort(pc[..., 0] / zs, pc[..., 1] / zs, cam.dist)
    return torch.stack([cam.fx * xd + cam.cx, cam.fy * yd + cam.cy], dim=-1), z


def pixel_to_ray(cam: Cam, u, v):
    xn, yn = _undistort((u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, cam.dist)
    d_cam = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)
    d_world = torch.einsum("ji,...j->...i", cam.R, d_cam)
    d_world = d_world / torch.linalg.norm(d_world, dim=-1, keepdim=True)
    return cam.center, d_world


def _pixel_grid(h: int, w: int, device):
    v = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return u, v


# --- scenes -------------------------------------------------------------


def _linspace01(n: int, device):
    return torch.arange(n, dtype=torch.float32, device=device) / (n - 1)


def bumps_depth(h: int, w: int, base: float = 500.0, amp: float = 30.0,
                freq: float = 3.0, device="cpu"):
    """Config 3's smooth Gaussian-bump height field, a depth map (h, w)."""
    v = _linspace01(h, device)[:, None]
    u = _linspace01(w, device)[None, :]
    z = base + amp * (
        torch.sin(2 * math.pi * freq * u) * torch.cos(2 * math.pi * freq * v)
        + 0.5 * torch.exp(-(((u - 0.5) ** 2 + (v - 0.5) ** 2) / 0.02)))
    return z.to(torch.float32)


def _cam_depth(cam: Cam, pts):
    return torch.einsum("j,...j->...", cam.R[2], pts) + cam.t[2]


def plane_depth(cam: Cam, h: int, w: int, point, normal):
    o, d = pixel_to_ray(cam, *_pixel_grid(h, w, cam.R.device))
    point = torch.as_tensor(point, dtype=torch.float32).to(o.device)
    normal = torch.as_tensor(normal, dtype=torch.float32).to(o.device)
    denom = torch.einsum("...i,i->...", d, normal)
    denom = torch.where(denom.abs() < 1e-9, 1e-9, denom)
    lam = torch.einsum("...i,i->...", point - o, normal) / denom
    return _cam_depth(cam, o + lam[..., None] * d)


def sphere_depth(cam: Cam, h: int, w: int, center, radius, background):
    o, d = pixel_to_ray(cam, *_pixel_grid(h, w, cam.R.device))
    c = torch.as_tensor(center, dtype=torch.float32).to(o.device)
    oc = o - c
    b = torch.einsum("...i,i->...", d, oc)
    cc = torch.einsum("...i,...i->...", oc, oc) - radius * radius
    disc = b * b - cc
    hit = disc > 0
    lam = -b - torch.sqrt(torch.where(hit, disc, 0.0))
    z = _cam_depth(cam, o + lam[..., None] * d)
    return torch.where(hit & (lam > 0), z, float(background))


def rocks_scene(cam: Cam, h: int, w: int, n: int = 18, seed: int = 0,
                plane_point=(0, 0, 580.0), plane_normal=(0.12, 0.08, -1.0)):
    """Config 5's world-anchored rock field: n spheres over a tilted plane."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-120, 120, n)
    ys = rng.uniform(-80, 80, n)
    rs = rng.uniform(14.0, 42.0, n)
    zs = 565.0 - 0.35 * rs + rng.uniform(-12, 12, n)
    depth = plane_depth(cam, h, w, plane_point, plane_normal)
    for x, y, z, r in zip(xs, ys, zs, rs):
        depth = torch.minimum(depth, sphere_depth(
            cam, h, w, (float(x), float(y), float(z)), float(r), background=1e6))
    return depth


# --- patterns and rendering ----------------------------------------------


def _gray_patterns(width: int, bits: int, device):
    """(bits, width) half-shifted, antialiased column Gray stripes."""
    n = 1 << bits
    bit_idx = torch.arange(bits - 1, -1, -1, dtype=torch.int32, device=device)

    def bits_at(x4):
        stripe = torch.remainder(
            torch.div(x4 * n * 2 + 4 * width, 8 * width, rounding_mode="floor"), n)
        g = stripe ^ (stripe >> 1)
        return ((g[None, :] >> bit_idx[:, None]) & 1).to(torch.float32)

    x4 = 4 * torch.arange(width, dtype=torch.int32, device=device)
    return 0.5 * (bits_at(x4 - 1) + bits_at(x4 + 1))


def sampled_patterns(proj_w: int, proj_h: int, bits: int, device):
    """White, black, the Gray stripes and their inverses: (2 + 2 bits, H, W)."""
    col = _gray_patterns(proj_w, bits, device)[:, None, :].expand(bits, proj_h, proj_w)
    return torch.cat([torch.ones((1, proj_h, proj_w), device=device),
                      torch.zeros((1, proj_h, proj_w), device=device),
                      col, 1.0 - col], dim=0)


def _bilinear_sample(img, x, y):
    H, W = img.shape[-2:]
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = x - x0
    fy = y - y0
    return (img[..., y0, x0] * (1 - fx) * (1 - fy) + img[..., y0, x1] * fx * (1 - fy)
            + img[..., y1, x0] * (1 - fx) * fy + img[..., y1, x1] * fx * fy)


def _fringe_series(n: int = 256, harmonics: int = 8):
    """The fringe profile 0.5 + 0.5 cos as its Fourier series (mean,
    [(m, amplitude, phase)] above 1e-7), as the program's renderer takes it
    with no gamma and no blur."""
    prof = (0.5 + 0.5 * np.cos(2 * np.pi * np.arange(n) / n)) ** 1.0
    coef = np.fft.rfft(prof) / n
    m = np.arange(1, harmonics + 1)
    amps = 2.0 * np.abs(coef[1:harmonics + 1])
    phis = np.angle(coef[1:harmonics + 1])
    return float(coef[0].real), [(int(i), float(a), float(p))
                                 for i, a, p in zip(m, amps, phis) if a > 1e-7]


def render_scan(cam: Cam, proj: Cam, depth, proj_w: int, proj_h: int, bits: int,
                steps: int, noise_std: float = 0.0, generator=None,
                ambient: float = 0.05) -> Rendered:
    """The (2 + 2 bits + steps, H, W) stack that ``cam`` sees of ``depth``
    lit by ``proj``, fringes of pitch proj_w / 2**bits evaluated at the
    exact projected column, Gaussian noise from ``generator``."""
    H, W = depth.shape
    dev = depth.device
    o, d = pixel_to_ray(cam, *_pixel_grid(H, W, dev))
    d_cam_z = torch.einsum("j,...j->...", cam.R[2], d)
    dz = torch.where(d_cam_z.abs() < 1e-9, 1e-9, d_cam_z)
    pts = o + (depth / dz)[..., None] * d
    uv_p, z_p = project(proj, pts)
    xp, yp = uv_p[..., 0], uv_p[..., 1]
    lit = ((z_p > 0) & (xp >= 0) & (xp <= proj_w - 1) & (yp >= 0) & (yp <= proj_h - 1))
    segs = [_bilinear_sample(sampled_patterns(proj_w, proj_h, bits, dev), xp, yp)]
    pitch = proj_w / (1 << bits)
    k = torch.arange(steps, dtype=torch.float32, device=dev)
    ph = 2.0 * math.pi * xp[None] / pitch - 2.0 * math.pi * k[:, None, None] / steps
    mean, harmonics = _fringe_series()
    fr = torch.full_like(ph, mean)
    for m, amp, phi in harmonics:
        fr = fr + amp * torch.cos(m * ph + phi)
    segs.append(fr)
    light = torch.where(lit[None], torch.cat(segs, dim=0), 0.0)
    frames = ambient + (1.0 - ambient) * light
    if noise_std > 0.0:
        frames = frames + noise_std * torch.randn(frames.shape, generator=generator,
                                                  device=dev)
    frames = torch.clamp(frames, 0.0, 1.0)
    return Rendered(frames=frames, points_true=pts, mask_true=lit)


def quantize_u8(frames):
    """[0, 1] frames -> raw 8-bit sensor counts."""
    return torch.clamp(torch.round(frames * 255.0), 0, 255.0).to(torch.uint8)
