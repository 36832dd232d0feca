"""N-step phase-shift fringe generation and wrapped-phase decoding.

Port of ``slr/codec/phaseshift.py``. Fringes:
``I_k(x) = A + B cos(2 pi x / p - 2 pi k / N)``; the N-step estimate is
``phi = atan2(sum_k I_k sin(2 pi k/N), sum_k I_k cos(2 pi k/N))`` and the
modulation ``B = (2/N) sqrt(S^2 + C^2)`` gates low-signal pixels.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def generate_phase_patterns(width: int, pitch: float, steps: int,
                            amplitude: float = 0.5, offset: float = 0.5,
                            device="cpu"):
    """(steps, width) fringe profiles I_k(x) = offset + amplitude*cos(2pi x/p - 2pi k/N)."""
    x = torch.arange(width, dtype=torch.float32, device=device)
    k = torch.arange(steps, dtype=torch.float32, device=device)
    phase = TWO_PI * x[None, :] / pitch - TWO_PI * k[:, None] / steps
    return offset + amplitude * torch.cos(phase)


def decode_phase(frames, steps: int):
    """Wrapped phase + modulation from the (steps, H, W) fringe stack.

    Returns (phi in [0, 2pi), modulation B >= 0).
    """
    k = torch.arange(steps, dtype=torch.float32, device=frames.device)
    delta = TWO_PI * k / steps
    S = torch.sum(frames * torch.sin(delta)[:, None, None], dim=0)
    C = torch.sum(frames * torch.cos(delta)[:, None, None], dim=0)
    phi = torch.atan2(S, C)  # (-pi, pi]
    phi = torch.where(phi < 0, phi + TWO_PI, phi)  # -> [0, 2pi)
    B = (2.0 / steps) * torch.sqrt(S * S + C * C)
    return phi, B
