"""Pixel-tile sharded reconstruction (port of ``slr/dist/sharded.py``).

Every rank holds the whole frame stack, as the reference's caller holds one
global array; a rank decodes its own rows (the ``shard_map`` body) and the
results are gathered along ``pixel_tile``, so every rank returns the whole
image with the same bits. Decode, unwrap and triangulation are row-local
except the spatial repair, whose coupling across tiles is carried by the
halo exchange: a halo of h rows buys h sweeps per exchange, since the
stale rows of a halo move one row inward per sweep and never reach the
tile within h sweeps, so the result is the unsharded sweep's, bit for bit.

A shard decodes through K1 (``fused_decode_triangulate`` at the shard's
global row offset) whenever the reference's kernel takes the pattern, and
through ``decode_stack`` otherwise; a shard's sweeps go through
``quality_unwrap`` (K3 or K4 by its route rule on the card, the plain sweep
on the CPU).
"""

from __future__ import annotations

import torch

from slr_torch.codec.patterns import decode_stack
from slr_torch.codec.unwrap import TWO_PI
from slr_torch.config import DecodeConfig, PatternConfig
from slr_torch.dist import comm
from slr_torch.dist.halo import halo_exchange_rows
from slr_torch.geom.camera import Camera
from slr_torch.geom.triangulate import triangulate_plane
from slr_torch.kernels.fused_scan import fused_decode_triangulate
from slr_torch.kernels.unwrap_scan import quality_unwrap

AXIS = "pixel_tile"


def _halo_unwrap(Phi_l, q_l, m_l, iters: int, mesh, exchange_every: int = 4):
    """``iters`` repair sweeps of a row shard, ``exchange_every`` sweeps per
    halo exchange (clamped to the shard's height). Phi, the quality and the
    mask travel as one (H_l, 3W) float32 payload a exchange."""
    if exchange_every < 1:
        raise ValueError(f"exchange_every must be >= 1, got {exchange_every}")
    q_l = torch.where(m_l, q_l, 0.0)
    m_f = m_l.to(torch.float32)
    W = Phi_l.shape[1]
    exchange_every = min(exchange_every, max(1, Phi_l.shape[0]))
    done = 0
    while done < iters:
        h = min(exchange_every, iters - done)
        done += h
        packed = halo_exchange_rows(torch.cat([Phi_l, q_l, m_f], dim=1), mesh, AXIS, h)
        Ph_h = quality_unwrap(packed[:, :W].contiguous(), packed[:, W:2 * W],
                              packed[:, 2 * W:] > 0.5, iters=h)
        Phi_l = Ph_h[h:-h]
    return Phi_l


def _rows(mesh, H: int):
    """This rank's rows [row0, row0 + rows_per) of an H-row image."""
    n = mesh.shape[AXIS]
    if H % n:
        raise ValueError(f"{H} image rows do not split over {n} pixel tiles")
    rows_per = H // n
    return mesh.coords[AXIS] * rows_per, rows_per


def sharded_unwrap(Phi, quality, mask, mesh, iters: int = 8, exchange_every: int = 4):
    """The voting repair with the image rows sharded over pixel_tile;
    ``exchange_every`` sweeps per halo exchange (the result does not depend
    on it). Every rank passes the whole (H, W) maps and gets the whole
    repaired Phi."""
    row0, rows_per = _rows(mesh, Phi.shape[0])
    rows = slice(row0, row0 + rows_per)
    out = _halo_unwrap(Phi[rows].to(torch.float32), quality[rows].to(torch.float32),
                       mask[rows].to(torch.bool), iters, mesh, exchange_every)
    return comm.all_gather_rows([out], mesh.groups[AXIS])[0]


def sharded_reconstruct(frames, cam: Camera, proj: Camera, cfg: PatternConfig,
                        dec: DecodeConfig, mesh, spatial_iters: int = 0):
    """Decode -> repair -> triangulate with the rows of the (F, H, W) stack
    sharded over pixel_tile (H divisible by the tiles). Returns (points
    (H, W, 3), mask, x_p, quality), gathered on every rank. A shard's rows
    carry their global index, so the camera model sees global pixels; after
    a repair every pixel is re-triangulated on its projector column."""
    row0, rows_per = _rows(mesh, frames.shape[1])
    frames_l = frames[:, row0:row0 + rows_per].contiguous()
    if cfg.use_inverse and cfg.phase_steps > 0:
        out = fused_decode_triangulate(frames_l, cam, proj, cfg, dec, row_offset=float(row0))
        x_p, mask, quality = out.x_p, out.mask > 0.5, out.quality
        pts = out.points.movedim(0, -1)
    else:
        res = decode_stack(frames_l, cfg, dec)
        x_p, mask, quality = res.x_p, res.mask, res.quality
        pts = None
    if spatial_iters:
        Phi = _halo_unwrap(x_p * (TWO_PI / cfg.fringe_pitch), quality, mask,
                           spatial_iters, mesh)
        x_p = Phi * (cfg.fringe_pitch / TWO_PI)
        pts = None   # x_p changed: re-triangulate below
    if pts is None:
        dev = x_p.device
        v = torch.arange(row0, row0 + rows_per, dtype=torch.float32, device=dev)
        u = torch.arange(x_p.shape[1], dtype=torch.float32, device=dev)
        pts, _ = triangulate_plane(cam, proj, u[None, :].expand_as(x_p),
                                   v[:, None].expand_as(x_p), x_p)
    return tuple(comm.all_gather_rows([pts, mask, x_p, quality], mesh.groups[AXIS]))
