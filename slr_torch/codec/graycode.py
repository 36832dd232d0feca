"""Gray-code pattern generation and per-pixel decoding.

Port of ``slr/codec/graycode.py``. Gray code: g = b ^ (b >> 1). Decode:
b_0 = g_0 (MSB), b_i = b_{i-1} ^ g_i. Patterns are MSB-first: frame i
stripes the projector into 2^(i+1) bands.
"""

from __future__ import annotations

import torch


def gray_encode(n):
    """Integer -> Gray code (elementwise)."""
    n = torch.as_tensor(n)
    return n ^ (n >> 1)


def gray_decode_int(g, bits: int):
    """Gray code -> integer, by the prefix-XOR chain over ``bits`` bits
    (doubling: O(log bits) ops instead of a per-bit loop)."""
    b = torch.as_tensor(g)
    shift = 1
    while shift < bits:
        b = b ^ (b >> shift)
        shift <<= 1
    return b


def generate_gray_patterns(width: int, bits: int, half_shift: bool = False,
                           antialias: bool = False, device="cpu"):
    """Per-bit stripe patterns for a ``width``-pixel projector axis.

    Returns (bits, width) float32 in [0,1]; row ``i`` is bit ``bits-1-i`` of
    the Gray code of the stripe index (MSB first). The stripe index of
    pixel x is ``x * 2**bits // width``; with ``half_shift`` the stripes
    are offset by half a stripe and wrap cyclically (stripe =
    floor(x/p + 1/2) mod 2^bits), the layout the temporal unwrap expects.
    ``antialias`` supersamples at x -/+ 0.25, so an edge inside a pixel
    gives 0.5.
    """
    n = 1 << bits
    bit_idx = torch.arange(bits - 1, -1, -1, dtype=torch.int32, device=device)

    def bits_at(x4):
        # x4: pixel coordinate scaled by 4 (quarter-pixel sampling grid)
        if half_shift:
            stripe = torch.remainder(
                torch.div(x4 * n * 2 + 4 * width, 8 * width,
                          rounding_mode="floor"), n)
        else:
            stripe = torch.clamp(
                torch.div(x4 * n, 4 * width, rounding_mode="floor"), 0, n - 1)
        g = gray_encode(stripe)
        return ((g[None, :] >> bit_idx[:, None]) & 1).to(torch.float32)

    x4 = 4 * torch.arange(width, dtype=torch.int32, device=device)
    if not antialias:
        return bits_at(x4)
    return 0.5 * (bits_at(x4 - 1) + bits_at(x4 + 1))


def decode_gray(frames_pat, frames_inv, white, black, bits: int,
                black_threshold: float = 0.1, white_threshold: float = 0.02):
    """Per-pixel Gray decode with shadow + certainty masking.

    frames_pat/frames_inv: (bits, H, W) captured pattern / inverse stacks
    (MSB first). white/black: (H, W) all-on / all-off frames.
    Returns (code (H,W) int32 stripe index, mask (H,W) bool).
    """
    mask = (white - black) > black_threshold
    diff = frames_pat - frames_inv
    bits_on = diff > 0
    mask = mask & torch.all(diff.abs() > white_threshold, dim=0)
    weights = 1 << torch.arange(bits - 1, -1, -1, dtype=torch.int32,
                                device=diff.device)
    g = torch.sum(bits_on.to(torch.int32) * weights[:, None, None], dim=0,
                  dtype=torch.int32)
    return gray_decode_int(g, bits), mask
