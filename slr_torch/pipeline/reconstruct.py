"""Single-scan reconstruction (port of ``slr/pipeline/reconstruct.py``).

``reconstruct_scan`` is the general unfused path (any pattern layout);
``reconstruct_dense`` is the production path: the fused kernel K1, the
optional spatial repair (voting, K3 or K4; or the wavefront, K5) and the
colour attach; ``reconstruct_scan_hdr`` fuses an exposure bracket, through
K2 for gray_phase coding with phase steps. ``DenseReconstructor`` holds the
calibration as module buffers, so ``.to(device)`` moves it with the module;
a 4-D input is a bracket.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from slr_torch import observability as obs
from slr_torch.codec.exposure import decode_multi_exposure
from slr_torch.codec.patterns import DecodeResult, decode_stack
from slr_torch.codec.unwrap import TWO_PI
from slr_torch.config import DecodeConfig, PatternConfig, ReconstructConfig
from slr_torch.geom.camera import Camera
from slr_torch.geom.triangulate import triangulate_plane, triangulate_rays
from slr_torch.kernels.fused_scan import (
    fused_decode_triangulate, fused_decode_triangulate_hdr)
from slr_torch.kernels.unwrap_scan import quality_unwrap
from slr_torch.kernels.wavefront import wavefront_repair

SPATIAL_MODES = ("voting", "wavefront")


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


def scan_cloud_from_numpy(points, mask, colors, quality, x_p, device="cpu") -> ScanCloud:
    """A cloud given as numpy arrays (the JAX ``ScanCloud`` after
    ``jax.tree.map(np.asarray, cloud)``) -> the port's ``ScanCloud``. This is
    how scans cross from the reference to the port."""
    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    return ScanCloud(points=f32(points),
                     mask=torch.as_tensor(np.array(mask, bool), device=device),
                     colors=f32(colors), quality=f32(quality), x_p=f32(x_p))


def _pixel_grid(H: int, W: int, device):
    v = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    u = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    return u, v


def _triangulate_decoded(res: DecodeResult, cam: Camera, proj: Camera,
                         rec: ReconstructConfig, colors) -> ScanCloud:
    u, v = _pixel_grid(*res.x_p.shape, res.x_p.device)
    if res.y_p is not None and rec.method in ("midpoint", "dlt"):
        pts, _ = triangulate_rays(cam, proj, u, v, res.x_p, res.y_p)
        depth = pts[..., 2]
    else:
        pts, depth = triangulate_plane(cam, proj, u, v, res.x_p)
    mask = res.mask & (depth > rec.min_depth) & (depth < rec.max_depth)
    pts = torch.where(mask[..., None], pts, 0.0)
    return ScanCloud(points=pts, mask=mask, colors=colors,
                     quality=res.quality, x_p=res.x_p)


def reconstruct_scan(
    frames, cam: Camera, proj: Camera, cfg: PatternConfig,
    dec: DecodeConfig = DecodeConfig(),
    rec: ReconstructConfig = ReconstructConfig(),
) -> ScanCloud:
    """General decode -> triangulate (configs 1-2; any pattern layout)."""
    return _triangulate_decoded(decode_stack(frames, cfg, dec), cam, proj,
                                rec, _white_color(frames))


def _bracket_colors(stacks, saturation: float):
    """Per pixel the brightest white frame of the bracket below
    ``saturation``, in [0, 1] (0 where every exposure saturates): the
    exposures' white frames converted at once."""
    whites = stacks[:, 0]
    if whites.is_floating_point():
        return torch.where(whites < saturation, whites, 0.0).amax(dim=0)
    whites = whites.to(torch.float32) / float(torch.iinfo(whites.dtype).max)
    # finite, so the product is the where's bits without a fill of its 0
    return (whites * (whites < saturation)).amax(dim=0)


def reconstruct_scan_hdr(
    stacks, cam: Camera, proj: Camera, cfg: PatternConfig,
    dec: DecodeConfig = DecodeConfig(),
    rec: ReconstructConfig = ReconstructConfig(),
    saturation: float = 0.98,
) -> ScanCloud:
    """Exposure-bracketed reconstruction of (E, F, H, W) stacks, one
    ``scan`` root span.

    gray_phase coding with inverse patterns and phase steps takes K2: one
    launch reads the bracket, fuses it per pixel and triangulates. Every
    other coding is decoded by ``decode_multi_exposure`` (per pixel the best
    usable exposure) and triangulated unfused. Colours come from the
    brightest unsaturated white frame of the bracket (``hdr.colors``).
    """
    with obs.span("scan"):
        with obs.span("hdr.colors"):
            colors = _bracket_colors(stacks, saturation)
        if (cfg.coding == "gray_phase" and cfg.use_inverse
                and cfg.phase_steps > 0):
            out = fused_decode_triangulate_hdr(
                stacks, cam, proj, cfg, dec, saturation=saturation,
                z_bounds=(rec.min_depth, rec.max_depth))
            return ScanCloud(points=out.points.movedim(0, -1), mask=out.mask > 0.5,
                             colors=colors, quality=out.quality, x_p=out.x_p)
        res = decode_multi_exposure(stacks, cfg, dec, saturation=saturation)
        return _triangulate_decoded(res, cam, proj, rec, colors)


def spatial_repair(x_p, quality, mask, pitch: float, spatial_iters: int,
                   spatial_mode: str = "voting"):
    """The spatial repair of a decoded projector column ``x_p`` (fringe
    period ``pitch``): "voting" runs ``spatial_iters`` strict-consensus
    sweeps (K3 or K4); "wavefront" the quality-ordered repair (K5) with
    ``max(1, spatial_iters // 4)`` rounds per level. Returns (repaired x_p,
    changed): a repair moves x_p by whole periods, so ``changed`` is
    ``mask & (|dx_p| > pitch / 2)``, never a pixel outside ``mask`` nor the
    float rounding of the x_p -> phase -> x_p round trip."""
    if spatial_mode not in SPATIAL_MODES:
        raise ValueError(f"spatial_mode must be one of {SPATIAL_MODES}, "
                         f"got {spatial_mode!r}")
    with obs.span("repair.phase"):
        Phi = x_p * (TWO_PI / pitch)
    with obs.span("repair.vote"):
        if spatial_mode == "wavefront":
            Phi = wavefront_repair(Phi, quality, mask,
                                   rounds_per_level=max(1, spatial_iters // 4))
        else:
            Phi = quality_unwrap(Phi, quality, mask, iters=spatial_iters)
    with obs.span("repair.phase"):
        x_p2 = Phi * (pitch / TWO_PI)
        return x_p2, mask & ((x_p2 - x_p).abs() > pitch / 2)


def reconstruct_dense(
    frames, cam: Camera, proj: Camera, cfg: PatternConfig,
    dec: DecodeConfig = DecodeConfig(),
    rec: ReconstructConfig = ReconstructConfig(),
    spatial_iters: int = 0,
    spatial_mode: str = "voting",
) -> ScanCloud:
    """Flagship fused path: one K1 launch per scan, any K1 branch
    (float32 or integer frames; Gray + phase, Gray only or multifreq;
    column plane, or midpoint when rows are coded).

    ``spatial_iters`` > 0 repairs fringe-order errors between decode and
    re-triangulation (``spatial_repair``, at the finest fringe period): the
    repaired pixels are re-triangulated on their projector-column plane and
    take the new points where their depth stays in bounds. The mask never
    grows, and every unrepaired pixel keeps K1's x_p and points.

    With ``spatial_iters`` 0, ``points`` is a (H, W, 3) view of the
    kernel's (3, H, W) output.
    """
    with obs.span("scan"):
        out = fused_decode_triangulate(
            frames, cam, proj, cfg, dec, z_bounds=(rec.min_depth, rec.max_depth))
        mask = out.mask > 0.5
        x_p = out.x_p
        pts = out.points.movedim(0, -1)
        if spatial_iters:
            with obs.span("repair"):
                pitch = (cfg.mf_pitches[-1] if cfg.coding == "multifreq"
                         else cfg.fringe_pitch)
                x_p2, changed = spatial_repair(x_p, out.quality, mask, pitch,
                                               spatial_iters, spatial_mode)
                with obs.span("repair.retriangulate"):
                    u, v = _pixel_grid(*x_p.shape, x_p.device)
                    pts2, depth2 = triangulate_plane(cam, proj, u, v, x_p2)
                    ok2 = (depth2 > rec.min_depth) & (depth2 < rec.max_depth)
                    pts = torch.where((changed & ok2)[..., None], pts2, pts)
                    x_p = torch.where(changed, x_p2, x_p)
        return ScanCloud(points=pts, mask=mask, colors=_white_color(frames),
                         quality=out.quality, x_p=x_p)


def is_bracket(frames, spatial_iters: int = 0) -> bool:
    """Whether ``frames`` is an (E, F, H, W) exposure bracket, which takes
    ``reconstruct_scan_hdr``, and not an (F, H, W) stack; the one rule of
    the stream, ``DenseReconstructor`` and ``Session``. No bracket route
    has the spatial repair: a bracket with ``spatial_iters`` > 0 raises
    ``ValueError``."""
    if frames.dim() != 4:
        return False
    if spatial_iters:
        raise ValueError("an exposure bracket has no spatial repair: "
                         "spatial_iters must be 0")
    return True


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
    """``reconstruct_dense`` with the calibration held as buffers; an
    (E, F, H, W) exposure bracket (``is_bracket``) goes to
    ``reconstruct_scan_hdr``. ``spatial_iters`` > 0 adds the spatial repair
    to single stacks, in the mode ``dec.spatial_unwrap_mode``, and is
    refused on a bracket."""

    def __init__(self, cam: Camera, proj: Camera, cfg: PatternConfig,
                 dec: DecodeConfig = DecodeConfig(),
                 rec: ReconstructConfig = ReconstructConfig(),
                 spatial_iters: int = 0):
        super().__init__()
        self.cfg, self.dec, self.rec = cfg, dec, rec
        self.spatial_iters = spatial_iters
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
        if is_bracket(frames, self.spatial_iters):
            return reconstruct_scan_hdr(frames, self.cam, self.proj, self.cfg,
                                        self.dec, self.rec)
        return reconstruct_dense(frames, self.cam, self.proj, self.cfg,
                                 self.dec, self.rec, self.spatial_iters,
                                 self.dec.spatial_unwrap_mode)
