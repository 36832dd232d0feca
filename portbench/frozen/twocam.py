"""The benchmark's frozen copy of the two-camera scanner: the rig, the
two-camera scene, the renderer with both projector axes coded and cast
shadows, and the ground truth on the projector grid. It imports nothing of
the program, so a later change to the program's synth cannot move the
benchmark's inputs; ``portbench/tests/test_portbench_twocam.py`` holds it
to the program's synth as the two stand today.

Origins, operation for operation:

- ``two_camera_rig``: ``slr_torch/synth/render.py::two_camera_rig``;
- ``spheres_scene``: ``slr_torch/synth/scene.py::spheres_scene`` (with
  ``plane_depth`` and ``sphere_depth``, already copied in ``synth.py``);
- ``render_pair_scan``: ``slr_torch/synth/render.py::render_scan`` with
  ``cast_shadows`` (``_shadow_cells``, ``_shadow_map``), no albedo, gamma 1
  and no defocus, and the pattern stack of
  ``slr_torch/codec/patterns.py::generate_pattern_stack`` for a
  ``gray_phase`` pattern with inverses on both axes;
- ``quantize_frames``: ``slr_torch/synth/render.py::quantize_frames``;
- ``proj_truth``: ``chip_smoke.py::two_camera_phases.proj_truth`` (after
  ``benchmarks/tpu_matrix.py:469-478``).
"""

from __future__ import annotations

import math

import torch

from portbench.frozen.synth import (
    Cam, Rendered, _bilinear_sample, _fringe_series, _gray_patterns, _pixel_grid,
    _toed_in, make_cam, pixel_to_ray, plane_depth, project, sphere_depth)

# spheres_scene's defaults: the plane, then (centre, radius) of each sphere
PLANE_POINT = (0.0, 0.0, 560.0)
PLANE_NORMAL = (0.15, 0.1, -1.0)
SPHERES = (((20.0, 5.0, 540.0), 140.0),
           ((-60.0, -40.0, 520.0), 60.0),
           ((70.0, 50.0, 530.0), 45.0))


def two_camera_rig(cam_w: int = 1280, cam_h: int = 1024, proj_w: int = 1024,
                   proj_h: int = 768, baseline: float = 280.0, toe_in_deg: float = 14.0,
                   device="cpu"):
    """Two cameras at x = -+ baseline / 2, toed in toward z ~ 500, and the
    projector at the origin between them: (cam1, cam2, proj)."""
    f_c = 0.9 * cam_w
    cams = []
    for sign in (-1.0, 1.0):
        R, t = _toed_in(sign * baseline / 2, sign * toe_in_deg)
        cams.append(make_cam(f_c, f_c, cam_w / 2 - 0.5, cam_h / 2 - 0.5, R=R, t=t,
                             device=device))
    f_p = 1.2 * proj_w
    proj = make_cam(f_p, f_p, proj_w / 2 - 0.5, proj_h / 2 - 0.5, device=device)
    return cams[0], cams[1], proj


def spheres_scene(cam: Cam, h: int, w: int, plane_point=PLANE_POINT,
                  plane_normal=PLANE_NORMAL, spheres=SPHERES):
    """A tilted plane and three unequal spheres (min depth), seen by ``cam``
    as a camera-frame depth map (h, w)."""
    depth = plane_depth(cam, h, w, plane_point, plane_normal)
    for center, radius in spheres:
        depth = torch.minimum(depth, sphere_depth(cam, h, w, center, radius,
                                                  background=1e6))
    return depth


def pattern_images(proj_w: int, proj_h: int, bits: int, row_bits: int, device):
    """The sampled frames of a Gray + phase pattern coding both axes: white,
    black, column Gray stripes and inverses, row stripes and inverses:
    (2 + 2 bits + 2 row_bits, proj_h, proj_w)."""
    col = _gray_patterns(proj_w, bits, device)[:, None, :].expand(bits, proj_h, proj_w)
    row = _gray_patterns(proj_h, row_bits, device)[:, :, None].expand(row_bits, proj_h, proj_w)
    return torch.cat([torch.ones((1, proj_h, proj_w), device=device),
                      torch.zeros((1, proj_h, proj_w), device=device),
                      col, 1.0 - col, row, 1.0 - row], dim=0)


def _shadow_cells(xp, yp, proj_w: int, proj_h: int):
    xi = torch.clamp(torch.round(xp).to(torch.int64), 0, proj_w - 1)
    yi = torch.clamp(torch.round(yp).to(torch.int64), 0, proj_h - 1)
    return yi * proj_w + xi


def _shadow_map(xp, yp, z_p, in_frustum, proj_w: int, proj_h: int):
    """Scatter-min projector-space depth map (proj_h, proj_w)."""
    z = torch.where(in_frustum, z_p, float("inf"))
    smap = torch.full((proj_h * proj_w,), float("inf"), device=z_p.device)
    smap.scatter_reduce_(0, _shadow_cells(xp, yp, proj_w, proj_h).reshape(-1),
                         z.reshape(-1), "amin", include_self=True)
    return smap.reshape(proj_h, proj_w)


def render_pair_scan(cam: Cam, proj: Cam, depth, proj_w: int, proj_h: int, bits: int,
                     row_bits: int, steps: int, row_steps: int, noise_std: float = 0.0,
                     generator=None, shadow_bias: float = 2.0,
                     ambient: float = 0.05) -> Rendered:
    """The (2 + 2 bits + 2 row_bits + steps + row_steps, H, W) stack that
    ``cam`` sees of ``depth`` lit by ``proj`` with both axes coded; a point
    that something nearer the projector hides (within ``shadow_bias``) gets
    ambient light only; Gaussian noise from ``generator``."""
    H, W = depth.shape
    dev = depth.device
    o, d = pixel_to_ray(cam, *_pixel_grid(H, W, dev))
    d_cam_z = torch.einsum("j,...j->...", cam.R[2], d)
    dz = torch.where(d_cam_z.abs() < 1e-9, 1e-9, d_cam_z)
    pts = o + (depth / dz)[..., None] * d
    uv_p, z_p = project(proj, pts)
    xp, yp = uv_p[..., 0], uv_p[..., 1]
    lit = ((z_p > 0) & (xp >= 0) & (xp <= proj_w - 1) & (yp >= 0) & (yp <= proj_h - 1))
    smap = _shadow_map(xp, yp, z_p, lit, proj_w, proj_h).reshape(-1)
    lit = lit & (z_p <= smap[_shadow_cells(xp, yp, proj_w, proj_h)] + shadow_bias)
    segs = [_bilinear_sample(pattern_images(proj_w, proj_h, bits, row_bits, dev), xp, yp)]
    mean, harmonics = _fringe_series()
    for coord, pitch, n in ((xp, proj_w / (1 << bits), steps),
                            (yp, proj_h / (1 << row_bits), row_steps)):
        k = torch.arange(n, dtype=torch.float32, device=dev)
        ph = 2.0 * math.pi * coord[None] / pitch - 2.0 * math.pi * k[:, None, None] / n
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


def quantize_frames(frames, dtype=torch.uint8):
    """[0, 1] frames -> raw sensor integers (8-bit ADC by default)."""
    m = float(torch.iinfo(dtype).max)
    return torch.clamp(torch.round(frames * m), 0, m).to(dtype)


def proj_truth(proj: Cam, proj_w: int, proj_h: int):
    """Ground truth on the projector grid: the first surface of the scene
    along each projector pixel's ray, (proj_h, proj_w, 3) world points."""
    dev = proj.R.device
    u, v = torch.meshgrid(torch.arange(proj_w, dtype=torch.float32, device=dev),
                          torch.arange(proj_h, dtype=torch.float32, device=dev),
                          indexing="xy")
    o, d = pixel_to_ray(proj, u, v)
    dz = torch.einsum("j,...j->...", proj.R[2], d)
    return o + (spheres_scene(proj, proj_h, proj_w) / dz)[..., None] * d
