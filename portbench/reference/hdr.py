"""Plain reference of one exposure-bracketed scan: the fuse of a uint8
(E, F, H, W) bracket, then the decode and triangulation of
``reference/scan.py``, written from the method's definition in plain
float32 PyTorch. It imports nothing of the program and takes nothing the
program made: only the raw bracket and the rig, as the benchmark generated
them.

The method (``slr/kernels/fused_scan.py::_hdr_kernel``'s description, with
the program's stated order, ``slr_torch/kernels/fused_scan.py``): for each
exposure, its phase sums S and C, its modulation B = (2 / N) sqrt(S² + C²)
and its usability, the contrast white - black above tau_black and the
white frame below the saturation, both in raw counts against thresholds
rounded once, ``round(tau * 255)``; the score is B where usable, else -1.
The Gray bits, and the usability that gates the pixel, are the best
exposure's, the first of the highest scores. The phase is the
modulation-weighted fuse over the usable exposures, sum B S / sum B and
sum B C / sum B, each sum taken in exposure order; its modulation gates
the pixel against tau_mod and is its quality. Then the fringe order,
column, fold, triangulation and depth bounds of ``reference/scan.py``. The
colour is the brightest white frame, as a [0, 1] value, below the
saturation (0 where every exposure saturates).

Departures from ``slr/kernels/fused_scan.py``'s description: the fused
sums are divided by sum B once (the program's order, ROADMAP §3: "K2 sums
sum B S / sum B"), where the JAX kernel normalises each weight first and
sums w S; the per-exposure phase sums, the column and the geometry are
matrix products, as in ``reference/scan.py``, so ``tf32=True`` rounds
their operands to TF32 (the control); the fuse over the exposures is
elementwise and stays float32 under ``tf32``.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.scan import TWO_PI, Cloud, Rig, _mm, _triangulate


def decode_bracket(bracket, rig: Rig, bits: int, steps: int, proj_w: int, dec: dict,
                   saturation: float, zmin: float, zmax: float, tf32: bool = False) -> Cloud:
    """One uint8 (E, 2 + 2 bits + steps, H, W) bracket -> its organized
    cloud."""
    if (bracket.dtype != torch.uint8 or bracket.dim() != 4
            or bracket.shape[1] != 2 + 2 * bits + steps):
        raise ValueError("the reference decodes uint8 brackets of Gray + inverse + "
                         "phase stacks")
    m = 255
    f = bracket.to(torch.int32)
    E, _, H, W = f.shape
    tau_b = int(round(dec["black_threshold"] * m))
    tau_w = int(round(dec["white_threshold"] * m))
    tau_sat = int(round(saturation * m))
    k = torch.arange(steps, dtype=torch.float64)
    wts = torch.stack([torch.sin(TWO_PI * k / steps), torch.cos(TWO_PI * k / steps)], -1)
    wts = wts.to(torch.float32).to(f.device)
    best = torch.zeros((H, W), dtype=torch.int64, device=f.device)
    sums = None
    for e in range(E):
        fr = f[e, 2 + 2 * bits:].reshape(steps, -1).T.to(torch.float32)
        sc = _mm(fr, wts, tf32)
        S, C = sc[:, 0].reshape(H, W), sc[:, 1].reshape(H, W)
        B = (2.0 / steps) * torch.sqrt(S * S + C * C)
        usable = ((f[e, 0] - f[e, 1]) > tau_b) & (f[e, 0] < tau_sat)
        score = torch.where(usable, B, -1.0)
        if e == 0:
            best_score = score
        else:
            take = score > best_score          # the first exposure wins ties
            best = torch.where(take, e, best)
            best_score = torch.where(take, score, best_score)
        w = torch.where(usable, B, 0.0)
        terms = (w, w * S, w * C)
        sums = terms if sums is None else tuple(a + t for a, t in zip(sums, terms))
    norm = torch.clamp_min(sums[0], 1e-20)
    S, C = sums[1] / norm, sums[2] / norm
    gray = torch.gather(f[:, 2:2 + 2 * bits], 0,
                        best[None, None].expand(1, 2 * bits, H, W))[0]
    valid = best_score >= 0.0
    stripe_gray = torch.zeros((H, W), dtype=torch.int32, device=f.device)
    for i in range(bits):
        d = gray[i] - gray[bits + i]
        stripe_gray = stripe_gray * 2 + (d > 0).to(torch.int32)
        valid &= d.abs() > tau_w
    stripe = torch.zeros_like(stripe_gray)
    bit = torch.zeros_like(stripe_gray)
    for i in range(bits - 1, -1, -1):     # Gray -> binary, MSB first
        bit = bit ^ ((stripe_gray >> i) & 1)
        stripe = stripe | (bit << i)
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
    whites = bracket[:, 0].to(torch.float32) / 255.0
    colors = torch.where(whites < saturation, whites, 0.0).amax(dim=0)
    return Cloud(points=torch.where(valid[..., None], pts, 0.0), mask=valid,
                 colors=colors, quality=mod / m, x_p=x_p)
