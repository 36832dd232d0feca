"""Calibration-board scene: chessboard albedo and plane depth from a pose
(port of ``slr/synth/board.py``).

Renders the physical calibration procedure: a chessboard at a known pose
under white light (for the corner detector) and under the full pattern
stack (for the decode -> projector-corner path), with the true corner
positions alongside.

Board frame: inner corner (i, j) sits at (j*square, i*square, 0), matching
``slr_torch.calib.board.board_object_points`` (and cv2's ordering). The
squares extend one square beyond the inner-corner grid on every side, then
a white margin of ``margin`` squares, then dark background.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slr_torch.calib.board import board_object_points
from slr_torch.config import PatternConfig
from slr_torch.geom.camera import Camera, pixel_to_ray, project
from slr_torch.geom.se3 import so3_exp
from slr_torch.synth.render import RenderedScan, render_scan


class BoardView(NamedTuple):
    white_image: torch.Tensor       # (H, W) white-lit capture for corner detect
    scan: RenderedScan              # pattern stack rendered on the board
    corners_cam_true: torch.Tensor  # (cols*rows, 2) true image corners
    corners_proj_true: torch.Tensor  # (cols*rows, 2) true projector coords
    depth: torch.Tensor             # (H, W) scene depth


def _board_plane_depth_albedo(cam: Camera, h: int, w: int, R_b, t_b,
                              cols: int, rows: int, square: float,
                              margin: float = 0.7,
                              background_depth: float = 1500.0,
                              background_albedo: float = 0.15,
                              dark: float = 0.12, light: float = 0.95):
    """Ray-cast the board plane; chessboard albedo in board coordinates."""
    dev = cam.fx.device
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    o, d = pixel_to_ray(cam, u, v)
    # plane through t_b with normal n = R_b e_z (board frame z=0)
    n = R_b[:, 2]
    denom = torch.einsum("j,...j->...", n, d)
    denom = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    lam = (torch.dot(n, t_b) - torch.dot(n, o)) / denom
    pts = o + lam[..., None] * d
    # board coordinates
    pb = torch.einsum("ji,...j->...i", R_b, pts - t_b)
    xb, yb = pb[..., 0], pb[..., 1]

    lo_x, hi_x = -square, cols * square
    lo_y, hi_y = -square, rows * square
    m = margin * square
    on_squares = (xb >= lo_x) & (xb <= hi_x) & (yb >= lo_y) & (yb <= hi_y)
    on_board = ((xb >= lo_x - m) & (xb <= hi_x + m)
                & (yb >= lo_y - m) & (yb <= hi_y + m))
    ij = (torch.floor(xb / square) + torch.floor(yb / square)).to(torch.int32)
    checker = torch.where(ij % 2 == 0, light, dark)
    albedo = torch.where(on_squares, checker,
                         torch.where(on_board, light, background_albedo))
    dz = torch.einsum("j,...j->...", cam.R[2], d)
    depth_board = lam * dz     # camera-z depth of the plane hit
    depth = torch.where((lam > 0) & on_board, depth_board, background_depth)
    return depth.to(torch.float32), albedo.to(torch.float32)


def render_board_view(
    cam: Camera,
    proj: Camera,
    cfg: PatternConfig,
    R_b, t_b,                   # board -> world pose
    cols: int, rows: int, square: float,
    cam_h: int, cam_w: int,
    noise_std: float = 0.0,
    generator: torch.Generator | None = None,
) -> BoardView:
    """Render one calibration view on the camera's device: the white-lit
    image and the full pattern scan. The white image is the stack's
    all-white frame (frame 0), the exposure a scan grabs first: the corner
    detector runs on it, the decoder on the rest. Noise from
    ``generator``."""
    dev = cam.fx.device
    R_b = torch.as_tensor(R_b, dtype=torch.float32, device=dev)
    t_b = torch.as_tensor(t_b, dtype=torch.float32, device=dev)
    depth, albedo = _board_plane_depth_albedo(cam, cam_h, cam_w, R_b, t_b,
                                              cols, rows, square)
    scan = render_scan(cam, proj, depth, cfg, albedo=albedo, noise_std=noise_std,
                       generator=generator)
    pts_world = board_object_points(cols, rows, square, dev) @ R_b.T + t_b
    uv_c, _ = project(cam, pts_world)
    uv_p, _ = project(proj, pts_world)
    return BoardView(white_image=scan.frames[0], scan=scan, corners_cam_true=uv_c,
                     corners_proj_true=uv_p, depth=depth)


def board_poses(n_views: int, cols: int, rows: int, square: float,
                seed: int = 0, z_range=(420.0, 650.0)):
    """Random well-conditioned board poses (board -> world) as (R, t) CPU
    tensors: numpy draws from ``seed``, the reference's own."""
    rng = np.random.default_rng(seed)
    center = torch.tensor([(cols - 1) * square / 2, (rows - 1) * square / 2, 0.0])
    poses = []
    for _ in range(n_views):
        rv = rng.uniform(-0.35, 0.35, 3)
        rv[2] = rng.uniform(-0.6, 0.6)
        z = rng.uniform(*z_range)
        lateral = rng.uniform(-30.0, 30.0, 2)
        R = so3_exp(torch.tensor(rv, dtype=torch.float32))
        target = torch.tensor([lateral[0], lateral[1], z], dtype=torch.float32)
        poses.append((R, target - R @ center))
    return poses
