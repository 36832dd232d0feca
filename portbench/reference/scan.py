"""Plain reference of one structured-light scan: decode, triangulate and
the strict-consensus repair, written from the method's definition in
plain PyTorch. It imports nothing of the program and takes nothing the
program made: only the raw uint8 stack and the rig, as the benchmark
generated them.

The method (the program's stated contract, ``slr_torch/kernels/
fused_scan.py`` and ``slr_torch/pipeline/reconstruct.py``'s docstrings):
integer stacks are compared in raw ADC counts against thresholds rounded
once, ``round(tau * 255)``; a pixel is valid when white - black exceeds
tau_black, every Gray bit differs from its inverse by more than tau_white,
and the N-step phase modulation exceeds tau_mod; the fringe order is the
half-shifted Gray stripe less [phi >= pi], modulo 2**bits; the column is
folded back by one coded period at its top edge; the point is the camera
ray (lens distortion zero) met with the projector's column plane; the
depth bounds gate the mask. The repair: each sweep, every valid pixel
whose valid 4-neighbours agree, at least 3 of them, on a non-zero whole
number of periods between their phase and its own moves by that many
periods; repaired pixels are re-triangulated and keep their new point
where its depth is within bounds.

Every linear map is a matrix product (the phase sums, the column from the
phase and the fringe order, the inverse intrinsics, the projector's column
and the plane's rotation). ``tf32=True`` rounds the operands of those
products to TF32's 10-bit mantissa, as the tensor cores do, and accumulates
in float32: that is the control, the precision below the float32 with TF32
off that the configuration states.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

TWO_PI = 2.0 * math.pi


class Cloud(NamedTuple):
    points: torch.Tensor   # (H, W, 3), 0 where invalid
    mask: torch.Tensor     # (H, W) bool
    colors: torch.Tensor   # (H, W) white frame in [0, 1]
    quality: torch.Tensor  # (H, W) phase modulation in [0, 1] units
    x_p: torch.Tensor      # (H, W) projector column


def round_tf32(x):
    """float32 -> the nearest TF32 value (10 explicit mantissa bits, ties
    to even), still stored as float32."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    b = torch.where(b >= 1 << 31, b - (1 << 32), b)
    return b.to(torch.int32).view(torch.float32)


def _mm(a, b, tf32: bool):
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


class Rig(NamedTuple):
    """What the reference needs of the rig, as plain numbers."""
    fx: float
    fy: float
    cx: float
    cy: float
    pfx: float
    pcx: float
    proj_R: torch.Tensor   # (3, 3) world -> projector
    proj_t: torch.Tensor   # (3,)


def rig_of(cam, proj) -> Rig:
    """The reference's view of a (camera, projector) pair of the frozen
    synth: the camera at the origin with no lens distortion, as the
    configuration states; anything else is refused."""
    if (torch.any(cam.dist != 0) or torch.any(proj.dist != 0)
            or not torch.equal(cam.R.cpu(), torch.eye(3)) or torch.any(cam.t != 0)):
        raise ValueError("the reference takes an undistorted rig with the camera "
                         "at the world origin")
    return Rig(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
               float(proj.fx), float(proj.cx), proj.R.float(), proj.t.float())


def _triangulate(rig: Rig, x_p, tf32: bool):
    """Camera ray of every pixel met with the projector column plane of its
    ``x_p``. Returns (points (H, W, 3), depth (H, W))."""
    H, W = x_p.shape
    dev = x_p.device
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    one = torch.ones_like(u)
    k_inv = torch.tensor([[1.0 / rig.fx, 0.0, 0.0], [0.0, 1.0 / rig.fy, 0.0],
                          [-rig.cx / rig.fx, -rig.cy / rig.fy, 1.0]], device=dev)
    ray = _mm(torch.stack([u, v, one], -1).reshape(-1, 3), k_inv, tf32)   # (xn, yn, 1)
    col = torch.tensor([[1.0 / rig.pfx], [-rig.pcx / rig.pfx]], device=dev)
    xnp = _mm(torch.stack([x_p.reshape(-1), one.reshape(-1)], -1), col, tf32)[:, 0]
    n_p = torch.stack([torch.ones_like(xnp), torch.zeros_like(xnp), -xnp], -1)
    R = rig.proj_R.to(dev)
    n_w = _mm(n_p, R, tf32)                       # R^T n_p, row-wise
    centre = -(R.T @ rig.proj_t.to(dev))          # projector centre, world
    num = _mm(n_w, centre[:, None], tf32)[:, 0]
    den = (n_w * ray).sum(-1)
    den = torch.where(den.abs() < 1e-12, 1e-12, den)
    lam = num / den
    pts = ray * lam[:, None]
    return pts.reshape(H, W, 3), lam.reshape(H, W)


def decode(frames, rig: Rig, bits: int, steps: int, proj_w: int, dec: dict,
           zmin: float, zmax: float, tf32: bool = False) -> Cloud:
    """One uint8 (2 + 2 bits + steps, H, W) stack -> its organized cloud."""
    if frames.dtype != torch.uint8 or frames.shape[0] != 2 + 2 * bits + steps:
        raise ValueError("the reference decodes uint8 Gray + inverse + phase stacks")
    m = 255
    f = frames.to(torch.int32)
    _, H, W = f.shape
    valid = (f[0] - f[1]) > int(round(dec["black_threshold"] * m))
    tau_w = int(round(dec["white_threshold"] * m))
    stripe_gray = torch.zeros((H, W), dtype=torch.int32, device=f.device)
    for i in range(bits):
        d = f[2 + i] - f[2 + bits + i]
        stripe_gray = stripe_gray * 2 + (d > 0).to(torch.int32)
        valid &= d.abs() > tau_w
    stripe = torch.zeros_like(stripe_gray)
    bit = torch.zeros_like(stripe_gray)
    for i in range(bits - 1, -1, -1):     # Gray -> binary, MSB first
        bit = bit ^ ((stripe_gray >> i) & 1)
        stripe = stripe | (bit << i)
    k = torch.arange(steps, dtype=torch.float64)
    w = torch.stack([torch.sin(TWO_PI * k / steps), torch.cos(TWO_PI * k / steps)], -1)
    fr = f[2 + 2 * bits:].reshape(steps, -1).T.to(torch.float32)
    sc = _mm(fr, w.to(torch.float32).to(f.device), tf32)
    S, C = sc[:, 0].reshape(H, W), sc[:, 1].reshape(H, W)
    phi = torch.atan2(S, C)
    phi = torch.where(phi < 0, phi + TWO_PI, phi)
    mod = (2.0 / steps) * torch.sqrt(S * S + C * C)
    valid &= mod > dec["modulation_threshold"] * m
    order = torch.remainder(stripe - (phi >= math.pi).to(torch.int32), 1 << bits)
    pitch = proj_w / (1 << bits)
    scale = torch.tensor([[pitch / TWO_PI], [pitch]], device=f.device)
    x_p = _mm(torch.stack([phi, order.to(torch.float32)], -1).reshape(-1, 2), scale,
              tf32).reshape(H, W)
    coded = pitch * (1 << bits)
    x_p = torch.where(x_p > coded - 0.5, x_p - coded, x_p)
    pts, depth = _triangulate(rig, x_p, tf32)
    valid &= (depth > zmin) & (depth < zmax)
    return Cloud(points=torch.where(valid[..., None], pts, 0.0), mask=valid,
                 colors=frames[0].to(torch.float32) / 255.0, quality=mod / m, x_p=x_p)


def _neighbour(a, dy: int, dx: int, fill):
    """``out[i, j] = a[i - dy, j - dx]``, ``fill`` outside the map."""
    H, W = a.shape
    out = torch.full_like(a, fill)
    out[max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] = \
        a[max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)]
    return out


def vote_repair(x_p, mask, pitch: float, sweeps: int):
    """``sweeps`` strict-consensus sweeps over the absolute phase of ``x_p``.
    Returns the repaired column map (every pixel, repaired or not)."""
    two_pi = torch.full((), TWO_PI, dtype=torch.float32, device=x_p.device)
    Phi = x_p * (TWO_PI / pitch)
    for _ in range(sweeps):
        votes, ok = [], []
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            votes.append(torch.round((_neighbour(Phi, dy, dx, 0.0) - Phi) / two_pi))
            ok.append(_neighbour(mask, dy, dx, False))
        shift = torch.zeros_like(Phi)
        for i in range(4):
            agree = sum(((votes[j] == votes[i]) & ok[j]).to(torch.int32) for j in range(4))
            take = ok[i] & (votes[i] != 0) & (agree >= 3)
            shift = torch.where(take, votes[i], shift)
        Phi = torch.where(mask, Phi + TWO_PI * shift, Phi)
    return Phi * (pitch / TWO_PI)


def repair(cloud: Cloud, rig: Rig, pitch: float, sweeps: int, zmin: float,
           zmax: float, tf32: bool = False) -> Cloud:
    """The decoded cloud after the repair: pixels whose column moved by
    more than half a period take the new column, and their re-triangulated
    point where its depth is within bounds; the mask never changes."""
    x2 = vote_repair(cloud.x_p, cloud.mask, pitch, sweeps)
    changed = cloud.mask & ((x2 - cloud.x_p).abs() > pitch / 2)
    pts2, depth2 = _triangulate(rig, x2, tf32)
    keep = changed & (depth2 > zmin) & (depth2 < zmax)
    return cloud._replace(points=torch.where(keep[..., None], pts2, cloud.points),
                          x_p=torch.where(changed, x2, cloud.x_p))


def off_pixel_share(got, ref: Cloud, tol: dict) -> float:
    """The share of pixels on which ``got`` (points, mask, colors, quality,
    x_p as tensors) disagrees with the reference: the masks differ, the
    colours differ at all, or, where both are valid, the point, the column
    or the quality differs by more than its tolerance."""
    dev = ref.mask.device
    g_pts, g_mask, g_col, g_q, g_xp = (x.to(dev) for x in got)
    both = g_mask & ref.mask
    off = (g_mask != ref.mask) | (g_col != ref.colors)
    d_pts = torch.linalg.norm(g_pts - ref.points, dim=-1)
    off |= both & ~(d_pts <= tol["points_mm"])
    off |= both & ~((g_xp - ref.x_p).abs() <= tol["x_p_px"])
    off |= both & ~((g_q - ref.quality).abs() <= tol["quality"])
    return float(off.sum()) / off.numel()


def repaired_miss_share(got, before: Cloud, after: Cloud, tol: dict) -> float:
    """Of the pixels the reference's repair moved by a period, the share on
    which ``got`` (as in ``off_pixel_share``) misses the repaired column or
    point; 0 where the reference repaired none."""
    dev = after.mask.device
    g_pts, g_mask, _, _, g_xp = (x.to(dev) for x in got)
    moved = after.mask & (after.x_p != before.x_p)
    n = int(moved.sum())
    if n == 0:
        return 0.0
    miss = ~(((g_xp - after.x_p).abs() <= tol["x_p_px"])
             & (torch.linalg.norm(g_pts - after.points, dim=-1) <= tol["points_mm"])) | ~g_mask
    return float((miss & moved).sum()) / n
