"""Surface normals of organized scan grids (port of ``slr/registration/normals.py``).

Central differences and a cross product per pixel, oriented toward the
camera at the origin.
"""

from __future__ import annotations

import torch

from slr_torch import observability as obs


def _shift(a, dy: int, dx: int):
    """``a`` rolled by (dy, dx) over its first two axes, with the row or
    column that wrapped around replaced by ``a``'s own edge."""
    out = torch.roll(a, (dy, dx), dims=(0, 1))
    if dy == 1:
        out[0] = a[0]
    elif dy == -1:
        out[-1] = a[-1]
    if dx == 1:
        out[:, 0] = a[:, 0]
    elif dx == -1:
        out[:, -1] = a[:, -1]
    return out


def grid_normals(points, mask=None):
    """points (H,W,3) organized cloud -> unit normals (H,W,3).

    Central differences with edge replication; an invalid neighbour (mask
    False) falls back to the pixel itself, so mask borders take forward or
    backward differences. Degenerate and masked pixels get (0, 0, -1).
    """
    if mask is None:
        mask = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)

    def masked_shift(dy, dx):
        valid = _shift(mask, dy, dx)[..., None]
        return torch.where(valid, _shift(points, dy, dx), points)

    dx = masked_shift(0, -1) - masked_shift(0, 1)
    dy = masked_shift(-1, 0) - masked_shift(1, 0)
    n = torch.cross(dx, dy, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.where(norm < 1e-12, 1.0, norm)
    # orient toward the camera at the origin: n . p < 0
    flip = torch.sum(n * points, dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    degenerate = (norm[..., 0] < 1e-12) | ~mask
    down = torch.zeros(3, dtype=n.dtype, device=n.device)
    with obs.wait("normals.axis"):          # a scalar from the host
        down[2] = -1.0
    return torch.where(degenerate[..., None], down, n)
