"""Virtual scanner forward model (port of ``slr/synth/render.py``).

For each camera pixel: cast the camera ray to the scene depth, project the
3D point into the projector, sample each projected pattern there, apply
ambient light and optional sensor noise. Exact ground truth rides along.

Only the subset that config 3 uses is ported: ``coding="gray_phase"``, an
ideal projector (no cast shadows, no defocus, gamma 1), uniform albedo
and the analytic phase fringes. The rest is ROADMAP slice 10. Noise
comes from a ``torch.Generator``; its bits differ from ``jax.random``'s.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

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
    th = torch.deg2rad(torch.tensor(toe_in_deg, dtype=torch.float32))
    c, s = torch.cos(th), torch.sin(th)
    z, o = torch.zeros(()), torch.ones(())
    R = torch.stack([torch.stack([c, z, s]), torch.stack([z, o, z]),
                     torch.stack([-s, z, c])])
    C = torch.tensor([baseline, 0.0, 0.0])  # projector centre, world
    t = -R @ C
    f_p = 1.2 * proj_w
    proj = make_camera(fx=f_p, fy=f_p, cx=proj_w / 2 - 0.5,
                       cy=proj_h / 2 - 0.5, dist=proj_dist, R=R, t=t,
                       device=device)
    return cam, proj


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
    ambient: float = 0.05,
    noise_std: float = 0.0,
    generator: Optional[torch.Generator] = None,
    cast_shadows: bool = False,
    defocus_sigma: float = 0.0,
    proj_gamma: float = 1.0,
) -> RenderedScan:
    """Render the (F, H, W) stack seen by ``cam`` of ``depth`` lit by ``proj``."""
    if cast_shadows or defocus_sigma != 0.0 or proj_gamma != 1.0:
        raise NotImplementedError(
            "cast shadows, defocus and projector gamma are ROADMAP slice 10")
    if cfg.coding != "gray_phase":
        raise NotImplementedError(
            f"rendering coding={cfg.coding!r} is ROADMAP slice 10")
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

    # the phase fringes are evaluated analytically at the exact projected
    # coordinate (a continuous sinusoid; bilinear interpolation of the
    # pitch-p pattern image would warp the phase); the other frames are
    # sampled from the pattern images
    ps, rps = cfg.phase_steps, cfg.row_phase_steps
    patterns = generate_pattern_stack(cfg, device=dev)
    segs = [_bilinear_sample(patterns[: patterns.shape[0] - ps - rps], xp, yp)]

    def analytic_fringes(coord, pitch: float, steps: int):
        k = torch.arange(steps, dtype=torch.float32, device=dev)
        ph = (2.0 * math.pi * coord[None] / pitch
              - 2.0 * math.pi * k[:, None, None] / steps)
        return 0.5 + 0.5 * torch.cos(ph)

    if ps:
        segs.append(analytic_fringes(xp, cfg.fringe_pitch, ps))
    if rps:
        segs.append(analytic_fringes(yp, cfg.row_fringe_pitch, rps))
    proj_light = torch.where(illuminated[None], torch.cat(segs, dim=0), 0.0)

    frames = ambient + (1.0 - ambient) * proj_light  # uniform albedo 1
    if noise_std > 0.0:
        frames = frames + noise_std * torch.randn(
            frames.shape, generator=generator, device=dev)
    frames = torch.clamp(frames, 0.0, 1.0)
    return RenderedScan(frames=frames, points_true=pts, xp_true=xp,
                        yp_true=yp, mask_true=illuminated)
