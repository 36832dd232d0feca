"""Single-scan reconstruction (port of ``slr/pipeline/reconstruct.py``).

``reconstruct_scan`` is the general unfused path (any gray_phase layout);
``reconstruct_dense`` is the production path: the fused kernel, colour
attach and nothing else. ``DenseReconstructor`` holds the calibration as
module buffers, so ``.to(device)`` moves it with the module.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from slr_torch.codec.patterns import decode_stack
from slr_torch.config import DecodeConfig, PatternConfig, ReconstructConfig
from slr_torch.geom.camera import Camera
from slr_torch.geom.triangulate import triangulate_plane, triangulate_rays
from slr_torch.kernels.fused_scan import fused_decode_triangulate


def _white_color(frames):
    """White-frame intensity in [0,1] regardless of the stack dtype."""
    w = frames[0]
    if not w.is_floating_point():
        return w.to(torch.float32) / float(torch.iinfo(w.dtype).max)
    return w


class ScanCloud(NamedTuple):
    """Organized point cloud: one entry per camera pixel (fixed shape)."""
    points: torch.Tensor     # (H, W, 3)
    mask: torch.Tensor       # (H, W) bool
    colors: torch.Tensor     # (H, W) intensity from the white frame
    quality: torch.Tensor    # (H, W)
    x_p: torch.Tensor        # (H, W)


def _pixel_grid(H: int, W: int, device):
    v = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    u = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    return u, v


def reconstruct_scan(
    frames, cam: Camera, proj: Camera, cfg: PatternConfig,
    dec: DecodeConfig = DecodeConfig(),
    rec: ReconstructConfig = ReconstructConfig(),
) -> ScanCloud:
    """General decode -> triangulate (configs 1-2; any pattern layout)."""
    res = decode_stack(frames, cfg, dec)
    u, v = _pixel_grid(*res.x_p.shape, res.x_p.device)
    if res.y_p is not None and rec.method in ("midpoint", "dlt"):
        pts, _ = triangulate_rays(cam, proj, u, v, res.x_p, res.y_p)
        depth = pts[..., 2]
    else:
        pts, depth = triangulate_plane(cam, proj, u, v, res.x_p)
    mask = res.mask & (depth > rec.min_depth) & (depth < rec.max_depth)
    pts = torch.where(mask[..., None], pts, 0.0)
    return ScanCloud(points=pts, mask=mask, colors=_white_color(frames),
                     quality=res.quality, x_p=res.x_p)


def reconstruct_dense(
    frames, cam: Camera, proj: Camera, cfg: PatternConfig,
    dec: DecodeConfig = DecodeConfig(),
    rec: ReconstructConfig = ReconstructConfig(),
    spatial_iters: int = 0,
) -> ScanCloud:
    """Flagship fused path (config 3): one kernel launch per scan.

    ``points`` is a (H, W, 3) view of the kernel's (3, H, W) output.
    """
    if spatial_iters:
        raise NotImplementedError(
            "the spatial quality repair (spatial_iters > 0) is ROADMAP slice 3")
    out = fused_decode_triangulate(
        frames, cam, proj, cfg, dec, z_bounds=(rec.min_depth, rec.max_depth))
    return ScanCloud(points=out.points.movedim(0, -1), mask=out.mask > 0.5,
                     colors=_white_color(frames), quality=out.quality,
                     x_p=out.x_p)


def accumulate_by_projector(cloud: ScanCloud, proj_width: int):
    """Projector-pixel accumulation.

    Camera pixels decoding to the same (camera row, projector column) cell
    are averaged. Returns (points (H, proj_W, 3), mask, colors) on the
    projector-column grid. One ``index_add_`` of the (count, point, colour)
    payload into a flat (H * proj_W + 1) buffer whose last cell collects
    the masked pixels.
    """
    H, W = cloud.mask.shape
    dev = cloud.mask.device
    col = torch.clamp(torch.round(cloud.x_p).to(torch.int64), 0, proj_width - 1)
    row = torch.arange(H, device=dev)[:, None]
    seg = torch.where(cloud.mask, row * proj_width + col, H * proj_width)
    w = cloud.mask.to(torch.float32)[..., None]
    payload = torch.cat([w, cloud.points * w, cloud.colors[..., None] * w],
                        dim=-1).reshape(H * W, 5)
    acc = torch.zeros((H * proj_width + 1, 5), device=dev)
    acc.index_add_(0, seg.reshape(-1), payload)
    acc = acc[:-1].reshape(H, proj_width, 5)
    cnt = acc[..., :1]
    denom = torch.where(cnt > 0, cnt, 1.0)
    return acc[..., 1:4] / denom, cnt[..., 0] > 0, (acc[..., 4:] / denom)[..., 0]


class DenseReconstructor(nn.Module):
    """``reconstruct_dense`` with the calibration held as buffers."""

    def __init__(self, cam: Camera, proj: Camera, cfg: PatternConfig,
                 dec: DecodeConfig = DecodeConfig(),
                 rec: ReconstructConfig = ReconstructConfig()):
        super().__init__()
        self.cfg, self.dec, self.rec = cfg, dec, rec
        for prefix, c in (("cam", cam), ("proj", proj)):
            for name, x in zip(Camera._fields, c):
                self.register_buffer(f"{prefix}_{name}", x)

    def _camera(self, prefix: str) -> Camera:
        return Camera(*(getattr(self, f"{prefix}_{n}") for n in Camera._fields))

    @property
    def cam(self) -> Camera:
        return self._camera("cam")

    @property
    def proj(self) -> Camera:
        return self._camera("proj")

    def forward(self, frames) -> ScanCloud:
        return reconstruct_dense(frames, self.cam, self.proj, self.cfg,
                                 self.dec, self.rec)
