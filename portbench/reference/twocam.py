"""Plain reference of the two-camera merge: both cameras' stacks decoded,
inverted onto the projector grid and triangulated by the midpoint of their
rays, written from the method's definition in plain PyTorch. It imports
nothing of the program and takes nothing the program made: only the two raw
uint8 stacks and the rig, as the benchmark generated them.

The method (the program's stated contract: ``slr_torch/pipeline/twocam.py``
``reconstruct_two_camera``, ``invert_to_projector``, ``_code_edge_mask``;
``slr_torch/kernels/crossing.py``; ``slr_torch/kernels/fused_scan.py`` and
``csrc/fused_scan.cu`` for the decode of both axes):

- Decode, per camera: integer stacks are compared in raw ADC counts
  against thresholds rounded once, ``round(tau * 255)``; a pixel is valid
  when white - black exceeds tau_black, every column and row Gray bit
  differs from its inverse by more than tau_white, and both axes' N-step
  phase modulation exceeds tau_mod * 255. Each axis' coordinate is
  ``(phi + 2 pi order) * pitch / (2 pi)`` (the sum rounded once, as K1's
  fused multiply-add gives it), the order the half-shifted Gray
  stripe less [phi >= pi] modulo 2**bits, folded back by one coded period
  at its top edge. The quality is the column modulation over 255.
- The code-edge mask: a pixel is dropped where its code (x_p, y_p) jumps by
  ``edge_tol`` (|dx| + |dy|) or more to a valid 4-neighbour.
- Each camera's maps are inverted onto the projector grid by two
  monotone-crossing passes. A pair (u, u + 1) of a row counts when both
  pixels are valid, its code step d lies in (dmin, dmax) and its gated
  channel steps less than its gate; it crosses every integer bin k with
  lo <= k < hi. Interpolated channels take q_lo + (k - lo) (q_hi - q_lo) / d
  at the crossing, nearest channels q_lo; a bin averages its crossings.
  Pass 1 runs along camera rows over x_p into proj_w bins, carrying (u,
  y_p) interpolated and (quality, white) nearest, gated on y_p's step <
  dmax; pass 2 runs along each projector column's camera rows over pass
  1's y, valid where pass 1 had a crossing, into proj_h bins, carrying (u,
  v) interpolated and (quality, white) nearest, gated on u's step < du_max.
- Every projector cell that both cameras found: the midpoint of the
  common perpendicular of the two cameras' rays (no lens distortion),
  kept where the rays pass within ``max_ray_gap`` and cam 1's depth lies
  strictly within the bounds. Quality: the lower of the two cameras'.
  Colour: cam 1's carried white, on every cell.

The arithmetic is the one the program's docstrings state, rounding for
rounding (``crossing.py``: a bin's terms summed in ascending pair order,
``q_lo - lo g`` and ``A + k B`` rounded once), so that the crossing of a
bin that a code lands on within an ulp goes the same way on both sides;
the one departure, the float64 sum behind a single rounding, can round
twice at a tie.

Every linear map of the geometry and the phase sums is a matrix product
(frames times the phase weights, the cameras' rotations and the depth
row). ``tf32=True`` rounds the operands of those
products to TF32's 10-bit mantissa, as the tensor cores do, and
accumulates in float32: that is the control, the precision below the
float32 with TF32 off that the configuration states.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench.reference.scan import round_tf32

TWO_PI = 2.0 * math.pi
F32 = torch.float32


class Merged(NamedTuple):
    points: torch.Tensor   # (proj_h, proj_w, 3), 0 where invalid
    mask: torch.Tensor     # (proj_h, proj_w) bool
    colors: torch.Tensor   # (proj_h, proj_w) cam 1's white in [0, 1]
    quality: torch.Tensor  # (proj_h, proj_w), 0 where invalid


class RigCam(NamedTuple):
    """A camera as plain numbers: intrinsics, world -> camera (R, t)."""
    fx: float
    fy: float
    cx: float
    cy: float
    R: torch.Tensor
    t: torch.Tensor


def rig_cam(cam) -> RigCam:
    """A frozen synth camera with no lens distortion, as the
    configuration states; a distorted one is refused."""
    if torch.any(cam.dist != 0):
        raise ValueError("the reference takes undistorted cameras")
    return RigCam(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                  cam.R.to(F32), cam.t.to(F32))


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=F32))


def _phase(f, first: int, steps: int, tf32: bool):
    """The N-step phase sums S = sum f_k sin(2 pi k / N), C likewise, of
    frames [first, first + steps): a product of the frames with the (N, 2)
    weights, summed in frame order; returns (phi in [0, 2 pi), mod)."""
    S = torch.zeros(f.shape[1:], dtype=F32, device=f.device)
    C = torch.zeros_like(S)
    for k in range(steps):
        w = torch.tensor([math.sin(TWO_PI * k / steps), math.cos(TWO_PI * k / steps)],
                         dtype=F32, device=f.device)
        if tf32:
            w = round_tf32(w)
        fk = f[first + k].to(F32)
        S = S + fk * w[0]
        C = C + fk * w[1]
    phi = torch.atan2(S, C)
    phi = torch.where(phi < 0, phi + TWO_PI, phi)
    return phi, _f32(2.0 / steps) * torch.sqrt(S * S + C * C)


def _gray(f, first: int, bits: int, tau_w: int):
    """MSB-first Gray bits at [first, first + bits) against their inverses
    at [first + bits, first + 2 bits): (binary stripe, every bit certain)."""
    g = torch.zeros(f.shape[1:], dtype=torch.int32, device=f.device)
    certain = torch.ones(f.shape[1:], dtype=torch.bool, device=f.device)
    for i in range(bits):
        d = f[first + i] - f[first + bits + i]
        g = g * 2 + (d > 0).to(torch.int32)
        certain &= d.abs() > tau_w
    b = torch.zeros_like(g)
    bit = torch.zeros_like(g)
    for i in range(bits - 1, -1, -1):
        bit = bit ^ ((g >> i) & 1)
        b = b | (bit << i)
    return b, certain


def _axis(phi, stripe, bits: int, pitch: float):
    """The cyclic half-shifted unwrap of one axis, folded at its top edge."""
    order = torch.remainder(stripe - (phi >= math.pi).to(torch.int32), 1 << bits)
    scale = _f32(pitch / TWO_PI)
    # phi + 2 pi order rounded once, as the card's fused multiply-add does:
    # the exact product of two float32 fits a float64
    x = (phi.double() + _f32(TWO_PI) * order.double()).to(F32) * scale
    coded = pitch * (1 << bits)
    return torch.where(x > coded - 0.5, x - coded, x)


def decode(frames, pat: dict, proj_w: int, proj_h: int, dec: dict, tf32: bool = False):
    """One uint8 stack coding both axes -> (x_p, y_p, valid, quality, white),
    each (H, W)."""
    b, rb, s, rs = pat["gray_bits"], pat["row_gray_bits"], pat["phase_steps"], pat["row_phase_steps"]
    if frames.dtype != torch.uint8 or frames.shape[0] != 2 + 2 * b + 2 * rb + s + rs:
        raise ValueError("the reference decodes uint8 two-axis Gray + inverse + phase stacks")
    m = 255
    f = frames.to(torch.int32)
    tau_w = int(round(dec["white_threshold"] * m))
    tau_mod = _f32(dec["modulation_threshold"] * m)
    valid = (f[0] - f[1]) > int(round(dec["black_threshold"] * m))
    col, c_ok = _gray(f, 2, b, tau_w)
    row, r_ok = _gray(f, 2 + 2 * b, rb, tau_w)
    phi, mod = _phase(f, 2 + 2 * b + 2 * rb, s, tf32)
    rphi, rmod = _phase(f, 2 + 2 * b + 2 * rb + s, rs, tf32)
    valid &= c_ok & r_ok & (mod > tau_mod) & (rmod > tau_mod)
    x_p = _axis(phi, col, b, proj_w / (1 << b))
    y_p = _axis(rphi, row, rb, proj_h / (1 << rb))
    return x_p, y_p, valid, mod * _f32(1.0 / m), frames[0].to(F32) / 255.0


def _neighbour(a, dy: int, dx: int, fill):
    """``out[i, j] = a[i - dy, j - dx]``, ``fill`` outside the map."""
    H, W = a.shape
    out = torch.full_like(a, fill)
    out[max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] = \
        a[max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)]
    return out


def code_edge_mask(x_p, y_p, valid, tol: float):
    """False where the code jumps by ``tol`` or more to a valid 4-neighbour."""
    jump = torch.zeros_like(x_p)
    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        d = ((_neighbour(x_p, dy, dx, 0.0) - x_p).abs()
             + (_neighbour(y_p, dy, dx, 0.0) - y_p).abs())
        jump = torch.maximum(jump, torch.where(_neighbour(valid, dy, dx, False), d, 0.0))
    return jump < tol


def _fma(a, b, c):
    """a * b + c rounded once to float32: the exact product of two float32
    fits a float64 (a tie of the float64 sum can round twice)."""
    return (a.double() * b.double() + c.double()).to(F32)


def crossing_pass(code, valid, channels, interp, bins: int, gate, dmin: float, dmax: float):
    """One monotone-crossing pass along the rows of ``code`` (R, U): the
    count of crossings of each integer bin and each channel (C, R, U) at
    them, 0 where none: (cnt (R, bins), vals (C, R, bins)). ``gate``:
    (channel, max step) that a pair's channel must step under.

    A crossing of bin k by pair u adds a = q_lo - lo g (rounded once) and
    g = (q_hi - q_lo) / d of an interpolated channel, q_lo of a nearest
    one; a bin adds its crossings in ascending pair order in float32, and
    its value is (A + k B) / n (A + k B rounded once; no division by one)."""
    R, U = code.shape
    dev = code.device
    lo, hi = code[:, :-1], code[:, 1:]
    d = hi - lo
    pair = valid[:, :-1] & valid[:, 1:] & (d > dmin) & (d < dmax)
    gc, gmax = gate
    pair &= (channels[gc][:, 1:] - channels[gc][:, :-1]).abs() < gmax
    # every (pair, j-th integer from ceil(lo)): d < dmax crosses at most ceil(dmax)
    J = math.ceil(dmax)
    k = torch.ceil(lo)[..., None] + torch.arange(J, dtype=F32, device=dev)
    fire = pair[..., None] & (lo[..., None] <= k) & (k < hi[..., None]) & (k >= 0) & (k < bins)
    row, u, j = fire.nonzero(as_tuple=True)         # in (row, pair, j) order
    kf = k[row, u, j]
    key = row * bins + kf.to(torch.int64)
    key, order = torch.sort(key, stable=True)       # each bin's crossings by ascending pair
    row, u, kf = row[order], u[order], kf[order]
    cl, dd = lo[row, u], d[row, u]
    start = torch.searchsorted(key, key, right=False)
    rank = torch.arange(key.numel(), device=dev) - start
    terms = [torch.ones_like(cl)]
    for c, lin in enumerate(interp):
        q_lo = channels[c][row, u]
        if lin:
            g = (channels[c][row, u + 1] - q_lo) / dd
            terms += [_fma(-cl, g, q_lo), g]
        else:
            terms.append(q_lo)
    terms = torch.stack(terms)                       # (T, crossings)
    acc = torch.zeros((terms.shape[0], R * bins), dtype=F32, device=dev)
    for r in range(int(rank.max()) + 1 if rank.numel() else 0):
        at = rank == r                               # one crossing a bin at a time
        acc[:, key[at]] = acc[:, key[at]] + terms[:, at]
    n = acc[0]
    kgrid = torch.arange(bins, dtype=F32, device=dev).repeat(R)
    vals, t = [], 1
    for lin in interp:
        v = _fma(kgrid, acc[t + 1], acc[t]) if lin else acc[t]
        t += 2 if lin else 1
        v = torch.where(n > 1, v / n.clamp(min=1.0), v)
        vals.append(torch.where(n > 0, v, 0.0))
    return n.reshape(R, bins), torch.stack(vals).reshape(len(interp), R, bins)


def invert_to_projector(x_p, y_p, valid, quality, white, proj_w: int, proj_h: int,
                        dmin: float, dmax: float, du_max: float):
    """Both passes: for every projector cell, (found, u, v, quality, white)
    of the camera, each (proj_h, proj_w)."""
    H, W = x_p.shape
    dev = x_p.device
    u = torch.arange(W, dtype=F32, device=dev)[None, :].expand(H, W)
    interp = (True, True, False, False)
    cnt1, (u1, y1, q1, w1) = crossing_pass(x_p, valid, torch.stack([u, y_p, quality, white]),
                                           interp, proj_w, (1, dmax), dmin, dmax)
    v = torch.arange(H, dtype=F32, device=dev)[None, :].expand(proj_w, H)
    cnt2, (u2, v2, q2, w2) = crossing_pass(y1.T, (cnt1 > 0.5).T,
                                           torch.stack([u1.T, v, q1.T, w1.T]), interp, proj_h,
                                           (0, du_max), dmin, dmax)
    return (cnt2 > 0.5).T, u2.T, v2.T, q2.T, w2.T


def _mm(a, b, tf32: bool):
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def rays(cam: RigCam, u, v, tf32: bool):
    """(origin (3,), unit world directions (..., 3)) of pixels (u, v): the
    normalised pixel ((u - cx) / fx, (v - cy) / fy, 1) turned into the world
    by R^T, a matrix product."""
    dev = u.device
    d_cam = torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, torch.ones_like(u)], -1)
    R = cam.R.to(dev)
    d = _mm(d_cam.reshape(-1, 3), R, tf32).reshape(d_cam.shape)   # R^T d, row-wise
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return -torch.einsum("ji,j->i", R, cam.t.to(dev)), d


def midpoint(o1, d1, o2, d2):
    """Midpoint of the common perpendicular of two rays, and their gap."""
    r = o1 - o2
    a, b, c = (d1 * d1).sum(-1), (d1 * d2).sum(-1), (d2 * d2).sum(-1)
    d, e = (d1 * r).sum(-1), (d2 * r).sum(-1)
    den = a * c - b * b
    den = torch.where(den.abs() < 1e-12, 1e-12, den)
    s = (b * e - c * d) / den
    t = (a * e - b * d) / den
    p1, p2 = o1 + s[..., None] * d1, o2 + t[..., None] * d2
    return 0.5 * (p1 + p2), torch.linalg.norm(p1 - p2, dim=-1)


def merge(frames1, frames2, cam1: RigCam, cam2: RigCam, cfg: dict, tf32: bool = False,
          max_ray_gap: float = 1.0, edge_tol: float = 3.0, dmin: float = 0.125,
          dmax: float = 2.5, du_max: float = 8.0) -> Merged:
    """The merged cloud on the projector grid of one pair of uint8 stacks.
    The defaults are ``reconstruct_two_camera``'s and
    ``invert_to_projector``'s stated defaults."""
    pat, pr, rc = cfg["pattern"], cfg["projector"], cfg["reconstruct"]
    found = []
    for frames in (frames1, frames2):
        x_p, y_p, valid, quality, white = decode(frames, pat, pr["width"], pr["height"],
                                                 cfg["decode"], tf32)
        valid = valid & code_edge_mask(x_p, y_p, valid, edge_tol)
        found.append(invert_to_projector(x_p, y_p, valid, quality, white, pr["width"],
                                         pr["height"], dmin, dmax, du_max))
    (ok1, u1, v1, q1, w1), (ok2, u2, v2, q2, _) = found
    o1, d1 = rays(cam1, u1, v1, tf32)
    o2, d2 = rays(cam2, u2, v2, tf32)
    pts, gap = midpoint(o1, d1, o2, d2)
    depth = _mm(pts.reshape(-1, 3), cam1.R[2].to(pts.device)[:, None],
                tf32).reshape(gap.shape) + cam1.t[2].to(pts.device)
    mask = ok1 & ok2 & (gap < max_ray_gap) & (depth > rc["min_depth"]) & (depth < rc["max_depth"])
    return Merged(points=torch.where(mask[..., None], pts, 0.0), mask=mask, colors=w1,
                  quality=torch.where(mask, torch.minimum(q1, q2), 0.0))


def off_cell_share(got, ref: Merged, tol: dict) -> float:
    """The share of projector cells on which ``got`` (points, mask, colors,
    quality as tensors) disagrees with the reference: the masks differ, or,
    where both are valid, the point, the quality or the colour differs by
    more than its tolerance."""
    dev = ref.mask.device
    g_pts, g_mask, g_col, g_q = (x.to(dev) for x in got)
    both = g_mask & ref.mask
    off = g_mask != ref.mask
    off |= both & ~(torch.linalg.norm(g_pts - ref.points, dim=-1) <= tol["points_mm"])
    off |= both & ~((g_q - ref.quality).abs() <= tol["quality"])
    off |= both & ~((g_col - ref.colors).abs() <= tol["color"])
    return float(off.sum()) / off.numel()


# the RMS of a cloud with no valid cell: past any limit, and a number JSON holds
NO_CELL_RMS_MM = 1e9


def truth_rms_mm(points, mask, truth) -> float:
    """RMS distance of the valid cells' points to the ground truth (mm);
    ``NO_CELL_RMS_MM`` where no cell is valid."""
    mask = mask.to(truth.device)
    n = int(mask.sum())
    if n == 0:
        return NO_CELL_RMS_MM
    err = torch.linalg.norm(points.to(truth.device) - truth, dim=-1)[mask]
    return math.sqrt(float((err.double() ** 2).sum()) / n)
