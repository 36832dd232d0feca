"""The benchmark's frozen yardstick arithmetic: the H100's data-sheet peaks
and the least work of each kernel a per-layer metric reads, computed from
the call's own shapes.

Copied from ``chip_smoke.py`` (origin noted at each line) and
``slr_torch/observability.py``; a later change to either cannot move these
numbers.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, 700 W (chip_smoke.py:96; observability.py's
# HBM_GBPS and F32_TFLOPS): HBM bandwidth and the fp32 rate outside the
# tensor cores, which issues 33.5e12 fp32 instructions a second, an FMA
# counting 2 operations (chip_smoke.py:147-148)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
FP32_ISSUE_PER_S = 33.5e12

# one strict-consensus sweep, instructions a pixel: two edge votes of 9 and
# a consensus of 12; K3 and K4 compute the same sweep and share this bound
# (chip_smoke.py:149-161)
VOTE_INSTR_PER_PX_SWEEP = 2 * 9 + 12


def k1_bytes(height: int, width: int, frames: int, frame_bytes: int) -> int:
    """K1's least HBM traffic: every frame read once (``frame_bytes`` a
    sample) and 7 float32 outputs a pixel written once (points x3, mask,
    quality, x_p, y_p): F * bytes + 28 bytes a pixel (chip_smoke.py:3444-3446;
    the float32 stack's 4 F + 28, the uint8 stack's F + 28)."""
    return (frames * frame_bytes + 7 * 4) * height * width


def vote_bytes(height: int, width: int) -> int:
    """The voting repair's least traffic: phase and mask in, the map out,
    each once, 9 bytes a pixel (chip_smoke.py:3448-3452)."""
    return (4 + 1 + 4) * height * width


def vote_instr(height: int, width: int, sweeps: int) -> int:
    """The voting repair's least fp32 instructions (chip_smoke.py:3532)."""
    return VOTE_INSTR_PER_PX_SWEEP * height * width * sweeps


def bound_s(nbytes: float = 0.0, instr: float = 0.0) -> float:
    """The least time for ``nbytes`` of HBM traffic and ``instr`` fp32
    instructions on one H100: the larger of the two (chip_smoke.py:3526-3531)."""
    return max(nbytes / HBM_BYTES_PER_S, instr / FP32_ISSUE_PER_S)


def k7_bytes(rows: int, codes: int, bins: int, channels: int = 4) -> int:
    """K7's traffic a pass with every input read once: code (4 B), valid
    (1 B) and ``channels`` carried channels (4 B) a pixel read, the count
    and each channel (4 B) a bin written (chip_smoke.py:1337-1340,
    ``crossing_k7_bytes``)."""
    return rows * codes * (5 + 4 * channels) + rows * bins * 4 * (1 + channels)
