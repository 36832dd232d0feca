"""The system under test as the benchmark calls it: the program's
configuration objects and cameras, made from a configuration file and the
frozen synth's rig. Every import of the program (``slr_torch``) by the
benchmark goes through this module or a traffic generator.

It also times the program's kernel builds (``slr_torch.kernels.build``
compiles each source once a checkout, then loads it), so that a run says
how much of its set-up was compiling.
"""

from __future__ import annotations

import functools
import time

from slr_torch.config import DecodeConfig, PatternConfig, ReconstructConfig
from slr_torch.geom.camera import Camera
from slr_torch.kernels import build as _build

# seconds spent in the program's builds (and in loading those already built)
build_seconds = [0.0]


def _timed(fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            build_seconds[0] += time.perf_counter() - t0
    return run


_build._compile = _timed(_build._compile)


def pattern_config(cfg: dict) -> PatternConfig:
    p, pr = cfg["pattern"], cfg["projector"]
    return PatternConfig(proj_width=pr["width"], proj_height=pr["height"],
                         coding=p["coding"], gray_bits=p["gray_bits"],
                         phase_steps=p["phase_steps"], use_inverse=p["use_inverse"])


def decode_config(cfg: dict) -> DecodeConfig:
    return DecodeConfig(**cfg["decode"])


def reconstruct_config(cfg: dict) -> ReconstructConfig:
    return ReconstructConfig(**cfg["reconstruct"])


def camera(cam, device) -> Camera:
    """The frozen synth's camera as the program's ``Camera``."""
    return Camera(*(x.to(device) for x in cam))
