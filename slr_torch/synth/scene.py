"""Synthetic scenes: camera-frame depth maps (port of ``slr/synth/scene.py``).

Only ``bumps_depth`` (the config-3 scene) and ``checker_albedo`` (the HDR
bracket's texture) are ported so far; the rest of ``slr.synth`` is ROADMAP
slice 10.
"""

from __future__ import annotations

import math

import torch


def _linspace01(n: int, device):
    # jnp.linspace(0, 1, n) in float32: iota / (n - 1), bit for bit
    return torch.arange(n, dtype=torch.float32, device=device) / (n - 1)


def bumps_depth(h: int, w: int, base: float = 500.0, amp: float = 30.0,
                freq: float = 3.0, device="cpu"):
    """Smooth Gaussian-bump height field as a direct depth map (h, w)."""
    v = _linspace01(h, device)[:, None]
    u = _linspace01(w, device)[None, :]
    z = base + amp * (
        torch.sin(2 * math.pi * freq * u) * torch.cos(2 * math.pi * freq * v)
        + 0.5 * torch.exp(-(((u - 0.5) ** 2 + (v - 0.5) ** 2) / 0.02))
    )
    return z.to(torch.float32)


def checker_albedo(h: int, w: int, cells: int = 8, lo: float = 0.4,
                   hi: float = 1.0, device="cpu"):
    """Checkerboard albedo (h, w) to exercise texture-dependent modulation."""
    v = torch.arange(h, device=device)[:, None]
    u = torch.arange(w, device=device)[None, :]
    c = ((u * cells // w) + (v * cells // h)) % 2
    return torch.where(c == 0, lo, hi).to(torch.float32)
