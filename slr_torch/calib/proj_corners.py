"""Projector corner coordinates from decoded structured light (port of
``slr/calib/proj_corners.py``).

The pattern stack rendered on the board is decoded per camera pixel into
projector coordinates (x_p, y_p); each detected chessboard corner is mapped
into the projector by a local homography fitted over the valid decoded
pixels around it (Moreno & Taubin's trick: robust to the masked dark-square
pixels beside every corner and to the sub-pixel corner falling between
decoded samples). Every corner at once: windows gathered at the
reference's clipped starts, one batched 9x9 ``eigh``.
"""

from __future__ import annotations

import torch

from slr_torch.calib.corners import _clipped_centre, _windows


def projector_corners_from_decode(x_p, y_p, mask, quality, corners, patch: int = 10):
    """Map sub-pixel image corners into projector coordinates.

    x_p, y_p: (H, W) decoded projector coords; mask (H, W) bool; quality
    (H, W) modulation; corners (N, 2) sub-pixel (x, y). Returns (proj_xy
    (N, 2), ok (N,) bool: enough valid support)."""
    H, W = x_p.shape
    P = 2 * patch + 1
    c = corners.to(torch.float32)
    cx = _clipped_centre(c[:, 0], patch, W)
    cy = _clipped_centre(c[:, 1], patch, H)
    xp, yp, m, q = _windows((x_p, y_p, mask.to(torch.float32), quality), cy, cx, patch)
    off = torch.arange(-patch, patch + 1, dtype=torch.float32, device=x_p.device)
    # pixel coords relative to the (sub-pixel) corner, unit = patch
    du = (cx.to(torch.float32)[:, None, None] + off[None, None, :] - c[:, 0, None, None]) / patch
    dv = (cy.to(torch.float32)[:, None, None] + off[None, :, None] - c[:, 1, None, None]) / patch
    du, dv = torch.broadcast_tensors(du, dv)
    w = m * q * torch.exp(-(du ** 2 + dv ** 2))

    def wsum(a):
        return torch.sum(w * a, dim=(-2, -1))

    wtot = torch.sum(w, dim=(-2, -1)) + 1e-12
    # normalize projector coords for conditioning
    xm = (wsum(xp) / wtot)[:, None, None]
    ym = (wsum(yp) / wtot)[:, None, None]
    s = torch.sqrt(wsum((xp - xm) ** 2 + (yp - ym) ** 2) / wtot)
    s = torch.clamp(s, min=1e-3)[:, None, None]
    dxp, dyp = (xp - xm) / s, (yp - ym) / s

    du_f, dv_f = du.reshape(-1, P * P), dv.reshape(-1, P * P)
    dx_f, dy_f = dxp.reshape(-1, P * P), dyp.reshape(-1, P * P)
    w_f = w.reshape(-1, P * P, 1)
    one, zero = torch.ones_like(du_f), torch.zeros_like(du_f)
    # DLT rows: [u v 1 0 0 0 -x'u -x'v -x'] and the y' counterpart
    a1 = torch.stack([du_f, dv_f, one, zero, zero, zero,
                      -dx_f * du_f, -dx_f * dv_f, -dx_f], dim=-1)
    a2 = torch.stack([zero, zero, zero, du_f, dv_f, one,
                      -dy_f * du_f, -dy_f * dv_f, -dy_f], dim=-1)
    M = (a1 * w_f).mT @ a1 + (a2 * w_f).mT @ a2
    _, vecs = torch.linalg.eigh(M)
    h = vecs[..., :, 0]
    h8 = torch.where(torch.abs(h[:, 8]) < 1e-12, 1e-12, h[:, 8])
    # the homography at the corner itself: du = dv = 0
    px = h[:, 2] / h8 * s[:, 0, 0] + xm[:, 0, 0]
    py = h[:, 5] / h8 * s[:, 0, 0] + ym[:, 0, 0]
    # support check: valid pixels on several sides of the corner
    ok = torch.sum(m, dim=(-2, -1)) > 0.25 * P * P
    return torch.stack([px, py], dim=-1), ok
