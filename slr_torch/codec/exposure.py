"""Multi-exposure (HDR) decode fusion (port of ``slr/codec/exposure.py``).

Every exposure of the bracket is decoded with ``decode_stack``; per pixel,
the exposure with the strongest *usable* phase modulation is taken. Usable
means valid under the usual shadow and certainty gates and unsaturated: the
white frame below ``saturation``. Saturated pixels clip the fringes, which
biases the phase although the modulation looks high, so saturation removes
an exposure from the choice outright.
"""

from __future__ import annotations

import torch

from slr_torch.codec.patterns import DecodeResult, decode_stack
from slr_torch.config import DecodeConfig, PatternConfig


def decode_multi_exposure(
    stacks,
    cfg: PatternConfig,
    dec: DecodeConfig = DecodeConfig(),
    saturation: float = 0.98,
) -> DecodeResult:
    """Fuse an (E, F, H, W) exposure bracket (float [0,1] or raw integers)
    into one decode. Every pixel carries the decode of its best usable
    exposure; ``mask`` is true where any exposure decodes validly
    unsaturated."""
    if stacks.dim() != 4:
        raise ValueError(f"stacks must be (E, F, H, W), got {tuple(stacks.shape)}")
    white = stacks[:, 0]
    if not stacks.is_floating_point():
        white = white.to(torch.float32) / float(torch.iinfo(stacks.dtype).max)

    res = [decode_stack(s, cfg, dec) for s in stacks]
    usable = torch.stack([r.mask for r in res]) & (white < saturation)
    quality = torch.stack([r.quality for r in res])
    # torch.argmax returns the first of equal maxima, as jnp.argmax does:
    # the first exposure wins a tie
    best = torch.argmax(torch.where(usable, quality, -1.0), dim=0)[None]

    def take(maps):
        return torch.take_along_dim(torch.stack(maps), best, dim=0)[0]

    return DecodeResult(
        x_p=take([r.x_p for r in res]),
        y_p=None if res[0].y_p is None else take([r.y_p for r in res]),
        mask=usable.any(dim=0),
        quality=take([r.quality for r in res]),
    )
