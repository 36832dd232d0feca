"""Temporal phase unwrapping (port of ``slr/codec/unwrap.py::unwrap_temporal``).

The spatial quality-guided repair is ROADMAP slice 3.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def unwrap_temporal(phi, code, bits: int, code_to_fringe_ratio: float = 1.0,
                    half_shifted: bool = True):
    """Absolute phase from wrapped phase + Gray-code stripe index.

    phi: (H,W) wrapped phase in [0, 2pi). code: (H,W) int stripe index.
    ``half_shifted``: cyclic half-shifted code, k = (s - [phi >= pi]) mod
    2^bits; otherwise the aligned minimum-distance rule
    k = round((c + 0.5) * r - phi / 2pi). Returns Phi (H,W) float32.
    """
    phi = phi.to(torch.float32)
    if half_shifted:
        k = code - (phi >= math.pi).to(code.dtype)
        k = torch.remainder(k, 1 << bits)
        return phi + TWO_PI * k.to(torch.float32)
    k = torch.round((code.to(torch.float32) + 0.5) * code_to_fringe_ratio
                    - phi / TWO_PI)
    return phi + TWO_PI * k
