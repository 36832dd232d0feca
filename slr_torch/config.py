"""Typed configuration for the port: the scan slice of ``slr.config``.

Restated field for field rather than imported, because importing
anything under ``slr`` imports JAX, which the GPU machine does not have.
``tests/test_torch_geom.py`` holds these classes equal to ``slr.config``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class PatternConfig:
    """Projected pattern-set description.

    Gray code: ``gray_bits`` column-stripe patterns + inverses (optionally
    row codes too), plus all-white / all-black frames. Phase shift:
    ``phase_steps`` sinusoidal fringes whose pitch equals the finest
    Gray-code stripe width so the code resolves the fringe order.
    """

    proj_width: int = 1024
    proj_height: int = 768
    # "gray_phase" = Gray code resolves the fringe order of a single-
    # frequency phase shift; "multifreq" = hierarchical phase-only coding
    coding: str = "gray_phase"
    gray_bits: int = 7
    row_gray_bits: int = 0       # 0 = column-only coding (plane triangulation)
    phase_steps: int = 4         # N-step phase shift; 0 disables phase shift
    row_phase_steps: int = 0     # row fringes; needs row_gray_bits > 0
    use_inverse: bool = True     # project inverted Gray patterns as well
    mf_levels: int = 3
    mf_ratio: float = 8.0

    def __post_init__(self):
        if self.coding not in ("gray_phase", "multifreq"):
            raise ValueError(f"unknown coding {self.coding!r}")
        if self.coding == "multifreq":
            if self.phase_steps < 3:
                raise ValueError("multifreq coding needs phase_steps >= 3")
            if self.row_gray_bits or self.row_phase_steps:
                raise ValueError("multifreq coding is column-only: row "
                                 "coding is not supported (use gray_phase)")
            if self.mf_levels < 1:
                raise ValueError("multifreq coding needs mf_levels >= 1")
        if self.row_phase_steps and not self.row_gray_bits:
            raise ValueError("row_phase_steps needs row_gray_bits > 0 "
                             "to resolve the row fringe order")

    @property
    def fringe_pitch(self) -> float:
        """Stripe pitch p = W / 2**bits; the fringe period in projector px."""
        return self.proj_width / (1 << self.gray_bits)

    @property
    def row_fringe_pitch(self) -> float:
        """Row stripe pitch p = H / 2**row_bits (row fringe period)."""
        return self.proj_height / (1 << self.row_gray_bits)

    @property
    def mf_pitches(self) -> Tuple[float, ...]:
        """Multifreq pitch ladder: level 0 spans the full projector width."""
        return tuple(self.proj_width / (self.mf_ratio ** i)
                     for i in range(self.mf_levels))

    @property
    def num_frames(self) -> int:
        """white + black + gray(+inv) [+ row gray(+inv)] + phase [+ row phase]
        (gray_phase), or white + black + mf_levels * phase_steps (multifreq)."""
        if self.coding == "multifreq":
            return 2 + self.mf_levels * self.phase_steps
        n = 2
        n += self.gray_bits * (2 if self.use_inverse else 1)
        n += self.row_gray_bits * (2 if self.use_inverse else 1)
        n += self.phase_steps
        n += self.row_phase_steps
        return n


@dataclass(frozen=True)
class DecodeConfig:
    """Per-pixel decode thresholds."""

    black_threshold: float = 0.1   # tau_black: white-black contrast for the shadow mask
    white_threshold: float = 0.02  # tau_white: |pattern - inverse| certainty per bit
    modulation_threshold: float = 0.05  # tau_mod: phase modulation B gate
    spatial_unwrap_iters: int = 8
    spatial_unwrap_mode: str = "voting"


@dataclass(frozen=True)
class ReconstructConfig:
    """Triangulation / cloud accumulation knobs."""

    method: str = "plane"         # 'plane' (column-only), 'midpoint', 'dlt'
    min_depth: float = 1.0        # z bounds filter, scene units
    max_depth: float = 1e4
    max_points: int = 1 << 20
    checked: bool = False
    min_valid_fraction: float = 0.01
    sor_k: int = 0
    sor_std_ratio: float = 2.0
    sor_voxel: float = 3.0
