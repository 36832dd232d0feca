"""Virtual scanner forward model (port of ``slr/synth/render.py``).

For each camera pixel: cast the camera ray to the scene depth, project the
3D point into the projector, sample each projected pattern there, apply
ambient light and optional sensor noise. Exact ground truth rides along.

Optics model:

- **cast shadows**: a projector-space scatter-min depth map; a point is lit
  only if nothing nearer the projector claims its projector pixel, within
  ``shadow_bias``. Shadowed pixels receive ambient light only.
- **defocus blur**: the projected patterns are convolved with a Gaussian
  PSF of ``defocus_sigma`` projector px; for the analytically evaluated
  sinusoidal fringes this is the exact closed form, harmonic m attenuated
  by exp(-2 (pi m sigma / pitch)^2) with its phase kept.
- **projector gamma**: ``proj_gamma`` raises the pattern luminance to a
  power before the blur; the fringes' Fourier series is that of the
  gamma'd profile (computed with numpy on the host, as the reference
  does), so N-step decoding sees the harmonics a real DLP chain makes.

Noise comes from a ``torch.Generator``; its bits differ from
``jax.random``'s.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from slr_torch.calib.corners import gaussian_blur
from slr_torch.codec.patterns import generate_pattern_stack
from slr_torch.config import PatternConfig
from slr_torch.geom.camera import Camera, make_camera, pixel_to_ray, project


class RenderedScan(NamedTuple):
    frames: torch.Tensor       # (F, H, W) captured stack in [0,1]
    points_true: torch.Tensor  # (H, W, 3) ground-truth 3D points (world=cam frame)
    xp_true: torch.Tensor      # (H, W) true projector column (sub-pixel)
    yp_true: torch.Tensor      # (H, W) true projector row
    mask_true: torch.Tensor    # (H, W) bool: point illuminated by projector


def default_rig(cam_w: int = 1280, cam_h: int = 1024, proj_w: int = 1024,
                proj_h: int = 768, baseline: float = 200.0,
                toe_in_deg: float = 12.0, cam_dist=None, proj_dist=None,
                device="cpu"):
    """A plausible scanner rig: camera at origin, projector at x=+baseline
    with a toe-in rotation about y so both frustums overlap around z ~ 500.
    R is built from float32 cos/sin of the float32 angle, as in slr."""
    f_c = 0.9 * cam_w
    cam = make_camera(fx=f_c, fy=f_c, cx=cam_w / 2 - 0.5, cy=cam_h / 2 - 0.5,
                      dist=cam_dist, device=device)
    R, t = _toed_in(baseline, toe_in_deg)   # projector centre at x = baseline
    f_p = 1.2 * proj_w
    proj = make_camera(fx=f_p, fy=f_p, cx=proj_w / 2 - 0.5,
                       cy=proj_h / 2 - 0.5, dist=proj_dist, R=R, t=t,
                       device=device)
    return cam, proj


def _toed_in(cx_world: float, deg: float):
    """(R, t) of a camera at (cx_world, 0, 0) turned by ``deg`` about y;
    R from float32 cos/sin of the float32 angle, as in slr."""
    th = torch.deg2rad(torch.tensor(deg, dtype=torch.float32))
    c, s = torch.cos(th), torch.sin(th)
    z, o = torch.zeros(()), torch.ones(())
    R = torch.stack([torch.stack([c, z, s]), torch.stack([z, o, z]),
                     torch.stack([-s, z, c])])
    return R, -R @ torch.tensor([cx_world, 0.0, 0.0])


def two_camera_rig(cam_w: int = 1280, cam_h: int = 1024, proj_w: int = 1024,
                   proj_h: int = 768, baseline: float = 280.0,
                   toe_in_deg: float = 14.0, device="cpu"):
    """Two cameras at x = -+ baseline/2, toed in toward a working volume
    around z ~ 500, and a projector at the origin between them. Returns
    (cam1, cam2, proj); two-camera reconstruction never reads ``proj``."""
    f_c = 0.9 * cam_w
    cams = []
    for sign in (-1.0, 1.0):
        R, t = _toed_in(sign * baseline / 2, sign * toe_in_deg)
        cams.append(make_camera(fx=f_c, fy=f_c, cx=cam_w / 2 - 0.5,
                                cy=cam_h / 2 - 0.5, R=R, t=t, device=device))
    f_p = 1.2 * proj_w
    proj = make_camera(fx=f_p, fy=f_p, cx=proj_w / 2 - 0.5, cy=proj_h / 2 - 0.5,
                       device=device)
    return cams[0], cams[1], proj


def move_rig(cam: Camera, proj: Camera, R_m, t_m):
    """Move the whole scanner rig by the pose (R_m, t_m) (rig -> world).

    Returns (cam', proj') that see the world scene from the moved rig:
    world -> cam' = (world -> cam) o T_rig^-1. Reconstruction with the
    original calibration then gives points in the rig frame, and
    registration must recover T_rig: exact multi-scan ground truth."""
    R_m = torch.as_tensor(R_m, dtype=torch.float32).to(cam.R.device)
    t_m = torch.as_tensor(t_m, dtype=torch.float32).to(cam.R.device)

    def mv(c: Camera) -> Camera:
        R_new = c.R @ R_m.T
        return c._replace(R=R_new, t=c.t - R_new @ t_m)

    return mv(cam), mv(proj)


def _bilinear_sample(img, x, y):
    """Sample (..., H, W) images at float coords (h, w), clamped to borders."""
    H, W = img.shape[-2:]
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = x - x0
    fy = y - y0
    v00 = img[..., y0, x0]
    v01 = img[..., y0, x1]
    v10 = img[..., y1, x0]
    v11 = img[..., y1, x1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _fringe_series(pitch: float, proj_gamma: float, defocus_sigma: float,
                   n: int = 256, harmonics: int = 8):
    """The fringe profile (0.5 + 0.5 cos)^gamma as a Fourier series: (mean,
    [(m, amplitude, phase)] of the harmonics above 1e-7), each amplitude
    attenuated by the Gaussian PSF's exp(-2 (pi m sigma / pitch)^2);
    gamma 1, sigma 0 is 0.5 + 0.5 cos. numpy on the host, static per call."""
    prof = (0.5 + 0.5 * np.cos(2 * np.pi * np.arange(n) / n)) ** proj_gamma
    coef = np.fft.rfft(prof) / n
    m = np.arange(1, harmonics + 1)
    amps = 2.0 * np.abs(coef[1:harmonics + 1])
    if defocus_sigma > 0.0:
        amps = amps * np.exp(-2.0 * (np.pi * m * defocus_sigma / pitch) ** 2)
    phis = np.angle(coef[1:harmonics + 1])
    return float(coef[0].real), [(int(i), float(a), float(p))
                                 for i, a, p in zip(m, amps, phis) if a > 1e-7]


def _shadow_cells(xp, yp, proj_w: int, proj_h: int):
    """Flat index of each point's nearest projector pixel."""
    xi = torch.clamp(torch.round(xp).to(torch.int64), 0, proj_w - 1)
    yi = torch.clamp(torch.round(yp).to(torch.int64), 0, proj_h - 1)
    return yi * proj_w + xi


def _shadow_map(xp, yp, z_p, in_frustum, proj_w: int, proj_h: int):
    """Scatter-min projector-space depth map (proj_h, proj_w) of the scene
    points: every point in the frustum splats its projector-frame depth
    onto its nearest projector pixel. A min is order-free, so the map is
    the same on every run and device."""
    z = torch.where(in_frustum, z_p, float("inf"))
    smap = torch.full((proj_h * proj_w,), float("inf"), device=z_p.device)
    smap.scatter_reduce_(0, _shadow_cells(xp, yp, proj_w, proj_h).reshape(-1),
                         z.reshape(-1), "amin", include_self=True)
    return smap.reshape(proj_h, proj_w)


def quantize_frames(frames, dtype=torch.uint8):
    """Quantize rendered [0,1] frames to raw sensor integers (8-bit ADC by
    default), the realistic camera output format."""
    m = float(torch.iinfo(dtype).max)
    return torch.clamp(torch.round(frames * m), 0, m).to(dtype)


def render_scan(
    cam: Camera,
    proj: Camera,
    depth,                      # (H, W) camera-frame depth along z
    cfg: PatternConfig,
    albedo: Optional[torch.Tensor] = None,   # (H, W) in [0,1]
    ambient: float = 0.05,
    noise_std: float = 0.0,
    generator: Optional[torch.Generator] = None,
    cast_shadows: bool = False,
    shadow_bias: float = 2.0,   # scene units; slope tolerance of the test
    defocus_sigma: float = 0.0,
    proj_gamma: float = 1.0,
) -> RenderedScan:
    """Render the (F, H, W) stack seen by ``cam`` of ``depth`` lit by ``proj``.
    ``cast_shadows``: points that something nearer the projector hides
    get ambient light only. ``defocus_sigma`` (projector px) and
    ``proj_gamma``: the projector's optics (module docstring)."""
    H, W = depth.shape
    dev = depth.device
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    o, d = pixel_to_ray(cam, u, v)
    # depth is along the CAMERA z axis: ray parameter = depth / (R_c d)_z
    d_cam_z = torch.einsum("j,...j->...", cam.R[2], d)
    dz = torch.where(d_cam_z.abs() < 1e-9, 1e-9, d_cam_z)
    pts = o + (depth / dz)[..., None] * d           # (H, W, 3) world frame

    uv_p, z_p = project(proj, pts)
    xp, yp = uv_p[..., 0], uv_p[..., 1]
    illuminated = ((z_p > 0) & (xp >= 0) & (xp <= cfg.proj_width - 1)
                   & (yp >= 0) & (yp <= cfg.proj_height - 1))
    if cast_shadows:
        smap = _shadow_map(xp, yp, z_p, illuminated, cfg.proj_width,
                           cfg.proj_height).reshape(-1)
        cells = _shadow_cells(xp, yp, cfg.proj_width, cfg.proj_height)
        illuminated = illuminated & (z_p <= smap[cells] + shadow_bias)

    # the phase fringes are evaluated analytically at the exact projected
    # coordinate (a continuous sinusoid; bilinear interpolation of the
    # pitch-p pattern image would warp the phase); the other frames are
    # sampled from the pattern images
    # (coordinate, pitch, steps) of each fringe set, in stack order
    if cfg.coding == "multifreq":
        fringes = [(xp, p, cfg.phase_steps) for p in cfg.mf_pitches]
    else:
        fringes = [f for f in ((xp, cfg.fringe_pitch, cfg.phase_steps),
                               (yp, cfg.row_fringe_pitch, cfg.row_phase_steps))
                   if f[2]]
    patterns = generate_pattern_stack(cfg, device=dev)
    n_sampled = patterns.shape[0] - sum(f[2] for f in fringes)
    patterns = patterns[:n_sampled]
    if proj_gamma != 1.0:
        patterns = torch.clamp(patterns, 0.0, 1.0) ** proj_gamma
    if defocus_sigma > 0.0:
        patterns = gaussian_blur(patterns, defocus_sigma)
    segs = [_bilinear_sample(patterns, xp, yp)]

    def analytic_fringes(coord, pitch: float, steps: int):
        k = torch.arange(steps, dtype=torch.float32, device=dev)
        ph = (2.0 * math.pi * coord[None] / pitch
              - 2.0 * math.pi * k[:, None, None] / steps)
        mean, harmonics = _fringe_series(pitch, proj_gamma, defocus_sigma)
        out = torch.full_like(ph, mean)
        for m, amp, phi in harmonics:
            out = out + amp * torch.cos(m * ph + phi)
        return out

    segs += [analytic_fringes(*f) for f in fringes]
    proj_light = torch.where(illuminated[None], torch.cat(segs, dim=0), 0.0)

    frames = ambient + (1.0 - ambient) * proj_light
    if albedo is not None:  # JAX multiplies by ones when None: exact
        frames = albedo[None] * frames
    if noise_std > 0.0:
        frames = frames + noise_std * torch.randn(
            frames.shape, generator=generator, device=dev)
    frames = torch.clamp(frames, 0.0, 1.0)
    return RenderedScan(frames=frames, points_true=pts, xp_true=xp,
                        yp_true=yp, mask_true=illuminated)
