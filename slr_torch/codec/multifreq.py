"""Multi-frequency phase-shift coding (phase-only, no Gray code).

Port of ``slr/codec/multifreq.py``. N-step fringe sets at decreasing
pitches p_0 > p_1 > ... (p_0 spans the full width, so its phase is already
absolute) are unwrapped hierarchically: each finer level's fringe order
comes from the previous level's absolute phase,

    k_i = round((Phi_{i-1} * p_{i-1} / p_i - phi_i) / (2 pi))
    Phi_i = phi_i + 2 pi k_i
"""

from __future__ import annotations

from typing import Sequence

import torch

from slr_torch.codec.phaseshift import TWO_PI, decode_phase, generate_phase_patterns


def default_pitches(width: int, levels: int = 3, ratio: float = 8.0):
    """Geometric pitch ladder: level 0 spans the full width."""
    return [width / (ratio ** i) for i in range(levels)]


def generate_multifreq_stack(width: int, height: int, pitches: Sequence[float],
                             steps: int = 4, device="cpu"):
    """(white, black, then ``steps`` fringes per pitch) -> (2+L*steps, H, W)."""
    frames = [torch.ones((1, height, width), device=device),
              torch.zeros((1, height, width), device=device)]
    for p in pitches:
        ph = generate_phase_patterns(width, p, steps, device=device)
        frames.append(ph[:, None, :].expand(steps, height, width))
    return torch.cat(frames, dim=0)


def decode_multifreq(frames, pitches: Sequence[float], steps: int = 4,
                     black_threshold: float = 0.1,
                     modulation_threshold: float = 0.05):
    """Hierarchical unwrap: (x_p, mask, quality) from a multi-freq stack.

    ``frames``: (2 + len(pitches)*steps, H, W) in the
    ``generate_multifreq_stack`` layout. ``x_p`` is the sub-pixel projector
    column from the finest pitch.
    """
    white, black = frames[0], frames[1]
    mask = (white - black) > black_threshold
    Phi_abs = None
    quality = None
    for i, p in enumerate(pitches):
        phi, B = decode_phase(frames[2 + i * steps: 2 + (i + 1) * steps], steps)
        mask = mask & (B > modulation_threshold)
        if Phi_abs is None:
            Phi_abs = phi          # pitch 0 spans the width: already absolute
            quality = B
        else:
            prev_in_cur = Phi_abs * (pitches[i - 1] / p)  # phase @ cur pitch
            k = torch.round((prev_in_cur - phi) / TWO_PI)
            Phi_abs = phi + TWO_PI * k
            quality = torch.minimum(quality, B)
    x_p = Phi_abs * pitches[-1] / TWO_PI
    # atan2 rounding at x=0 can wrap to the top of the unambiguous range
    # (one coarse period); fold it back, as in the Gray-code path
    x_p = torch.where(x_p > pitches[0] - 0.5, x_p - pitches[0], x_p)
    return x_p, mask, quality
