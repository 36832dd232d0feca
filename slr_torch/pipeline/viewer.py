"""Point-cloud preview rendering (port of ``slr/pipeline/viewer.py``).

Headless and on the cloud's device: the points are projected and
z-buffered with a scatter-min, then written as PNG (cv2 when importable)
or binary PPM. Both scatters (``amin`` for the z-buffer, ``amax`` for the
winner's colour) are order-free, so the image is the same bits on every
device and equal to the reference's. A turntable sequence gives the
"rotate the model" interaction as a sequence of stills.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from slr_torch.io.checkpoint import as_numpy

_BIG = 3.4e38


def _view_transform(points, R, t):
    """``points @ R.T + t`` rounded as XLA's CPU dot rounds it:
    fma(p2, R[:, 2], fma(p1, R[:, 1], p0 * R[:, 0])) + t, each fused
    multiply-add taken in float64 (the float32 product is exact there) and
    rounded to float32. Elementwise torch operations are rounded alike on
    every device, where a matmul's order is the library's."""
    acc = points[:, 0:1] * R[:, 0]
    for k in (1, 2):
        acc = (points[:, k:k + 1].double() * R[:, k].double() + acc.double()).float()
    return acc + t


def splat_points(points, colors, view_R, view_t, size: int = 640,
                 splat: int = 1, fov: float = 0.9):
    """Z-buffered splat of an (N,3) cloud into a (size,size,3) float image.

    view_R/view_t map world -> view coordinates (the view looks down +z).
    ``splat`` grows each point into a (2*splat+1)^2 pixel block so sparse
    clouds stay visible. Returns (img, depth) with background 0 / 3.4e38.
    """
    dev = points.device
    pts = _view_transform(points, view_R, view_t)
    z = pts[:, 2]
    valid = z > 1e-3
    # the reference's f: 0.5 * size / tan(0.5 * fov), rounded once to float32
    f = torch.tensor(0.5 * size, dtype=torch.float32) / torch.tan(
        torch.tensor(0.5 * fov, dtype=torch.float32))
    f = f.to(dev)
    zs = torch.where(valid, z, 1.0)
    u = f * pts[:, 0] / zs + 0.5 * size
    v = f * pts[:, 1] / zs + 0.5 * size

    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    ui = torch.round(u).to(torch.int32)
    vi = torch.round(v).to(torch.int32)

    offs = list(range(-splat, splat + 1))
    idxs, zvals = [], []
    for du in offs:
        for dv in offs:
            uu, vv = ui + du, vi + dv
            ok = valid & (uu >= 0) & (uu < size) & (vv >= 0) & (vv < size)
            idxs.append(torch.where(ok, vv * size + uu, 0).to(torch.int64))
            zvals.append(torch.where(ok, z, big))
    idx_all = torch.cat(idxs)
    z_all = torch.cat(zvals)
    depth = torch.full((size * size,), _BIG, dtype=torch.float32, device=dev)
    depth.scatter_reduce_(0, idx_all, z_all, reduce="amin")

    # winner-takes-pixel colour: a point colours every pixel whose z-buffer
    # entry it (nearly) owns; ties blend harmlessly through max
    col = colors.to(torch.float32)
    if col.dim() == 1:
        col = col[:, None].repeat(1, 3)
    col_all = col.repeat(len(offs) ** 2, 1)
    win = (z_all <= depth[idx_all] * (1.0 + 1e-4)) & (z_all < big)
    img = torch.zeros((size * size, 3), dtype=torch.float32, device=dev)
    img.scatter_reduce_(0, idx_all[:, None].expand(-1, 3),
                        torch.where(win[:, None], col_all, 0.0), reduce="amax")

    # depth-cued shading so monochrome clouds still read as 3-D
    d = depth.reshape(size, size)
    have = d < big
    dmin = torch.where(have, d, big).min()
    dmax = torch.where(have, d, -big).max()
    shade = 1.0 - 0.5 * torch.clamp((d - dmin) / (dmax - dmin + 1e-6), 0, 1)
    img = img.reshape(size, size, 3) * torch.where(have, shade, 0.0)[..., None]
    return img, d


def _look_at_cloud(points: np.ndarray, azimuth: float, elevation: float = 0.35):
    """View pose orbiting the cloud's bounding sphere (host float64, as the
    reference)."""
    ctr = points.mean(0)
    rad = float(np.linalg.norm(points - ctr, axis=1).max()) + 1e-6
    ca, sa = np.cos(azimuth), np.sin(azimuth)
    ce, se = np.cos(elevation), np.sin(elevation)
    # the view's position on the orbit sphere
    eye = ctr + 2.6 * rad * np.array([sa * ce, -se, -ca * ce])
    fwd = ctr - eye
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right) + 1e-9
    up2 = np.cross(fwd, right)
    R = np.stack([right, up2, fwd]).astype(np.float32)  # world->view
    t = (-R @ eye).astype(np.float32)
    return R, t


def write_image(path, img01) -> str:
    """Write an (H,W,3) float [0,1] image as PNG (cv2) or PPM without it."""
    path = Path(path)
    u8 = (np.clip(as_numpy(img01), 0, 1) * 255 + 0.5).astype(np.uint8)
    try:
        import cv2
        path = path.with_suffix(".png")
        cv2.imwrite(str(path), u8[..., ::-1])  # RGB -> BGR
    except ImportError:
        path = path.with_suffix(".ppm")
        with open(path, "wb") as f:
            f.write(f"P6\n{u8.shape[1]} {u8.shape[0]}\n255\n".encode())
            f.write(u8.tobytes())
    return str(path)


def render_cloud_image(points, colors=None, azimuth: float = 0.6,
                       size: int = 640, splat: int = 1, device=None) -> torch.Tensor:
    """Render one view of the cloud; the splat runs on ``device`` (default:
    the points' device when they are a tensor, else the CPU). Returns the
    (size, size, 3) image there."""
    if device is None:
        device = points.device if torch.is_tensor(points) else "cpu"
    pts = np.asarray(as_numpy(points), np.float32)
    if colors is None:
        col = np.full((pts.shape[0], 3), 0.85, np.float32)
    else:
        col = np.asarray(as_numpy(colors), np.float32)
        if col.max() > 1.5:
            col = col / 255.0
        if col.ndim == 1:
            col = np.repeat(col[:, None], 3, 1)
    R, t = _look_at_cloud(pts, azimuth)
    img, _ = splat_points(*(torch.from_numpy(a).to(device) for a in (pts, col, R, t)),
                          size=size, splat=splat)
    return img


def render_turntable(points, colors=None, out_prefix=None, frames: int = 1,
                     size: int = 640, splat: int = 1, device=None) -> list:
    """Render ``frames`` orbit views; returns the written file paths."""
    out_prefix = out_prefix or "preview"
    outs = []
    for i in range(max(1, frames)):
        az = 0.6 + 2.0 * math.pi * i / max(1, frames)
        img = render_cloud_image(points, colors, azimuth=az, size=size,
                                 splat=splat, device=device)
        outs.append(write_image(f"{out_prefix}_{i:02d}", img))
    return outs
