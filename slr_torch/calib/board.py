"""Calibration-board fixtures: object points and synthetic detected corners
(port of ``slr/calib/board.py``).

"Detection" here is the projection of known board poses through a known
camera, optionally with detection noise: the role the corner detector plays
for the solver downstream. The noise comes from a ``torch.Generator``; its
bits differ from ``jax.random``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from slr_torch.geom.camera import Camera, project
from slr_torch.geom.se3 import so3_exp


def board_object_points(cols: int, rows: int, square: float, device="cpu"):
    """(cols*rows, 3) planar board points, z=0, row-major like cv2."""
    j, i = np.meshgrid(np.arange(cols), np.arange(rows))
    pts = np.stack([j.ravel() * square, i.ravel() * square,
                    np.zeros(cols * rows)], axis=1)
    return torch.as_tensor(pts, dtype=torch.float32, device=device)


def synth_board_views(
    cam: Camera,
    cols: int,
    rows: int,
    square: float,
    n_views: int,
    seed: int = 0,
    noise_px: float = 0.0,
    z_range=(400.0, 700.0),
    generator: torch.Generator | None = None,
):
    """Random board poses in front of ``cam``, on its device.

    Returns (obj (N,3), img (V,N,2), rvecs (V,3), tvecs (V,3)). Poses (numpy
    draws from ``seed``, as the reference's): tilts < 30 deg, in-plane
    rotation < 46 deg, the board centre near the optical axis at depth in
    ``z_range``. ``noise_px``: Gaussian corner noise from ``generator``.
    """
    dev = cam.fx.device
    obj = board_object_points(cols, rows, square, dev)
    rng = np.random.default_rng(seed)
    center = torch.tensor([(cols - 1) * square / 2, (rows - 1) * square / 2, 0.0],
                          device=dev)
    rvecs, tvecs, img = [], [], []
    for _ in range(n_views):
        rv = rng.uniform(-0.45, 0.45, 3)
        rv[2] = rng.uniform(-0.8, 0.8)  # in-plane rotation can be bigger
        z = rng.uniform(*z_range)
        rv = torch.tensor(rv, dtype=torch.float32, device=dev)
        R = so3_exp(rv)
        lateral = rng.uniform(-40.0, 40.0, 2)
        target = torch.tensor([lateral[0], lateral[1], z], dtype=torch.float32, device=dev)
        t = target - R @ center
        uv, _ = project(cam, obj @ R.T + t)
        if noise_px > 0:
            uv = uv + noise_px * torch.randn(uv.shape, generator=generator, device=dev)
        rvecs.append(rv)
        tvecs.append(t)
        img.append(uv)
    return obj, torch.stack(img), torch.stack(rvecs), torch.stack(tvecs)
