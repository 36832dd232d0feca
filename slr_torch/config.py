"""Typed configuration for the port: every class of ``slr.config``, with
``ScanConfig`` saved and loaded as JSON (or YAML by extension).

Restated field for field rather than imported, because importing
anything under ``slr`` imports JAX, which the GPU machine does not have.
``tests/test_torch_geom.py`` holds these classes equal to ``slr.config``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
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
class CalibConfig:
    """Zhang calibration solver knobs."""

    board_cols: int = 9           # inner corners per row
    board_rows: int = 6
    square_size: float = 20.0     # board square edge, mm
    num_dist_coeffs: int = 5      # k1 k2 p1 p2 k3
    lm_iters: int = 50
    lm_lambda_init: float = 1e-3
    lm_lambda_up: float = 10.0
    lm_lambda_down: float = 0.1
    lm_tol: float = 1e-10


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


@dataclass(frozen=True)
class RegistrationConfig:
    """Feature+RANSAC coarse alignment and ICP refinement."""

    ransac_iters: int = 256
    # matched keypoints are distinct subsample draws, so a perfect alignment
    # still leaves pairs ~one point-spacing apart: the RANSAC inlier radius
    # is a few spacings (ICP owns fine accuracy)
    ransac_inlier_dist: float = 5.0
    icp_iters: int = 20
    icp_max_corr_dist: float = 10.0
    icp_sample_points: int = 4096
    voxel_size: float = 2.0
    # pose graph
    pg_iters: int = 20
    pg_damping: float = 1e-6


@dataclass(frozen=True)
class DistConfig:
    """Device layout: ``pixel_tiles`` shards the image rows of a scan,
    ``map_blocks`` shards scans and landmark fragments. Either past 1 needs
    that many GPUs, which the port's multi-GPU tier (ROADMAP slice 8)
    brings; on one GPU the session runs single-device."""

    pixel_tiles: int = 1
    map_blocks: int = 1
    halo: int = 1  # rows exchanged between pixel tiles for the spatial unwrap


@dataclass(frozen=True)
class ScanConfig:
    """Top-level session config bundling every stage."""

    pattern: PatternConfig = field(default_factory=PatternConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    calib: CalibConfig = field(default_factory=CalibConfig)
    reconstruct: ReconstructConfig = field(default_factory=ReconstructConfig)
    registration: RegistrationConfig = field(default_factory=RegistrationConfig)
    dist: DistConfig = field(default_factory=DistConfig)
    cam_width: int = 1280
    cam_height: int = 1024


def _to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def save_config(cfg: ScanConfig, path) -> None:
    """JSON, or YAML when the path ends in .yaml/.yml; the file is the
    reference's byte for byte, so either package opens the other's."""
    path = str(path)
    d = _to_dict(cfg)
    with open(path, "w") as f:
        if path.endswith((".yaml", ".yml")):
            import yaml

            yaml.safe_dump(d, f, sort_keys=False)
        else:
            json.dump(d, f, indent=2)


def load_config(path) -> ScanConfig:
    path = str(path)
    with open(path) as f:
        if path.endswith((".yaml", ".yml")):
            import yaml

            d = yaml.safe_load(f)
        else:
            d = json.load(f)
    return ScanConfig(
        pattern=PatternConfig(**d.get("pattern", {})),
        decode=DecodeConfig(**d.get("decode", {})),
        calib=CalibConfig(**d.get("calib", {})),
        reconstruct=ReconstructConfig(**d.get("reconstruct", {})),
        registration=RegistrationConfig(**d.get("registration", {})),
        dist=DistConfig(**d.get("dist", {})),
        cam_width=d.get("cam_width", 1280),
        cam_height=d.get("cam_height", 1024),
    )
