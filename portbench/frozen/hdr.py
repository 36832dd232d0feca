"""The benchmark's frozen copy of the three-exposure HDR capture: the
checkerboard albedo, the bracket renderer and K2's least byte count.

``checker_albedo`` is copied from ``slr_torch/synth/scene.py:113-119``;
``render_bracket`` from ``chip_smoke.py:3589-3595`` (itself the
reference's ``benchmarks/tpu_matrix.py:569-579``), on top of the frozen
``synth.render_scan`` with no noise; ``k2_bytes`` from
``chip_smoke.py:3628-3629``. It imports nothing of the program: a later
change to the program's synth or to ``chip_smoke.py`` cannot move these
inputs or this bound.

One departure from the source's render: the frozen renderer clamps its
frames to [0, 1] before the albedo multiplies them, the program's after.
The unclamped frames lie in [0.05, 1] up to a rounding, so the two differ
at most by an ulp where a frame rounds above 1.
"""

from __future__ import annotations

import torch

from portbench.frozen import synth


def checker_albedo(h: int, w: int, cells: int = 8, lo: float = 0.4, hi: float = 1.0,
                   device="cpu"):
    """Checkerboard albedo (h, w): ``cells`` squares a row, ``lo`` and
    ``hi`` alternating from ``lo`` at the top left."""
    v = torch.arange(h, device=device)[:, None]
    u = torch.arange(w, device=device)[None, :]
    c = ((u * cells // w) + (v * cells // h)) % 2
    return torch.where(c == 0, lo, hi).to(torch.float32)


def render_bracket(cam, proj, depth, proj_w: int, proj_h: int, bits: int, steps: int,
                   hdr: dict, generator=None):
    """The (E, 2 + 2 bits + steps, H, W) uint8 bracket that ``cam`` sees of
    ``depth`` under ``hdr["albedo"]``'s checkerboard: one noiseless render,
    then for each gain of ``hdr["gains"]`` an independent capture, the
    render times the gain plus its own Gaussian noise of
    ``hdr["noise_std"]`` from ``generator``, clamped and quantised."""
    H, W = depth.shape
    a = hdr["albedo"]
    albedo = checker_albedo(H, W, cells=a["cells"], lo=a["lo"], hi=a["hi"],
                            device=depth.device)
    frames = albedo[None] * synth.render_scan(cam, proj, depth, proj_w, proj_h, bits,
                                              steps).frames
    return torch.stack([synth.quantize_u8(torch.clamp(
        frames * g + hdr["noise_std"] * torch.randn(frames.shape, generator=generator,
                                                    device=frames.device), 0.0, 1.0))
        for g in hdr["gains"]])


def k2_bytes(height: int, width: int, exposures: int, steps: int, bits: int) -> int:
    """K2's least HBM traffic on a uint8 bracket: the white, black and phase
    frames of every exposure and the 2 bits Gray frames (with inverses) of
    one exposure read once, and 7 float32 planes a pixel written once:
    E (2 + steps) + 2 bits + 28 bytes a pixel (chip_smoke.py:3628-3629)."""
    return (exposures * (2 + steps) + 2 * bits + 7 * 4) * height * width
