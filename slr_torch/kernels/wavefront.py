"""Quality-guided wavefront repair on the card: kernel K5.

Port of ``slr/kernels/wavefront.py``. K5, ``launch_wavefront_pass``
(``_pass_rows``), is one directional growth pass: a Hillis-Steele scan of
each line's (tag, ps, pv) monoid elements in the association of the plain
version ``slr_torch.codec.unwrap.directional_pass``, held in registers (8
elements a thread, 16 for lines past 8,192) with warp shuffles and, across
warps, shared memory; then the wavefront update. A row pass takes a row a
block; a column pass up to 8 adjacent columns a block, staged through
shared memory so that its reads and writes go a map row at a time. The axis
and the direction are arguments of the kernel: no transposes or flips
around it. The kernel rounds (x - ps) / 2pi by a reciprocal and one FMA
correction; ``cycles_mismatches`` counts, on the card, the float32 inputs
where that differs from the plain version's division: none of 2^32 (and
the same for the voting kernels' rounding, up to the sign of a zero).

``wavefront_unwrap`` and ``wavefront_repair`` are the reference's entry points
(levels x rounds x four directions) with K5 as their pass; they share the
loop of the plain route, ``slr_torch.codec.unwrap.wavefront``. A CPU
tensor takes the plain pass; a CUDA tensor launches K5, or raises.
"""

from __future__ import annotations

import torch

from slr_torch.codec.unwrap import directional_pass, repair_trust, wavefront
from slr_torch.kernels.build import expect, launch
from slr_torch.kernels.unwrap_scan import library

MAX_LINE = 10240  # K5's 16-element build: 640 threads a block


def launch_wavefront_pass(phi, elig, Phi, done, axis: int, reverse: bool):
    """K5: one pass along ``axis`` (1: rows, 0: columns), upstream at lower
    indices or, ``reverse``, higher ones. phi, Phi float32; elig, done bool.
    Returns new (Phi, done)."""
    H, W = phi.shape
    f32, b8 = torch.float32, torch.bool
    expect("K5", (phi, (H, W), f32), (elig, (H, W), b8), (Phi, (H, W), f32), (done, (H, W), b8))
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if (W if axis == 1 else H) > MAX_LINE:
        raise ValueError(f"K5 scans lines of at most {MAX_LINE} pixels")
    Phi_out, done_out = torch.empty_like(Phi), torch.empty_like(done)
    launch(library(), "slr_wavefront_pass", "K5 wavefront_pass", phi.device,
           phi.data_ptr(), elig.data_ptr(), Phi.data_ptr(), done.data_ptr(),
           Phi_out.data_ptr(), done_out.data_ptr(), H, W, axis, int(reverse),
           counter="launches.k5")
    return Phi_out, done_out


def cycles_mismatches(device) -> tuple[int, int]:
    """K5 rounds (x - ps) / 2pi by a reciprocal and one FMA correction, not
    by a division, and so do the voting kernels K3 and K4 (without K5's
    guard for a zero quotient): the numbers of float32 inputs x, of all
    2^32, on which K5's rounding differs in any bit from the IEEE
    division's (the plain versions'), and on which the voting kernels'
    differs other than in the sign of a zero. Runs on the card."""
    count = torch.zeros(2, dtype=torch.int64, device=device)
    launch(library(), "slr_wavefront_cycles_check", "cycles_check", count.device,
           count.data_ptr())
    return tuple(count.tolist())


def wavefront_pass(phi, elig, Phi, done, axis: int, reverse: bool):
    """One directional pass: the plain version for a CPU tensor, K5 for a
    CUDA tensor (counted as ``launches.k5``)."""
    if phi.device.type == "cpu":
        return directional_pass(phi, elig, Phi, done, axis, reverse)
    return launch_wavefront_pass(phi, elig, Phi, done, axis, reverse)


def wavefront_unwrap(phi, quality, mask, Phi_init=None, trust=None,
                     levels: int = 4, rounds_per_level: int = 2):
    """``quality_guided_unwrap`` (phase-only and repair modes) with K5 as
    its pass: levels * rounds_per_level * 4 launches. Returns (Phi,
    reached)."""
    phi = phi.to(torch.float32).contiguous()
    if Phi_init is not None:
        Phi_init = Phi_init.to(torch.float32).contiguous()
    return wavefront(phi, quality, mask.contiguous(), Phi_init, trust, levels,
                     rounds_per_level, wavefront_pass)


def wavefront_repair(Phi, quality, mask, trust_quantile: float = 0.5,
                     levels: int = 2, rounds_per_level: int = 1):
    """``quality_guided_repair`` with K5. The reference's repair-mode
    defaults: trusted sources are dense, so two thresholds and one round
    (8 passes) reach order-error blobs."""
    phi, trust = repair_trust(Phi, quality, mask, trust_quantile)
    return wavefront_unwrap(phi, quality, mask, Phi_init=Phi, trust=trust,
                            levels=levels, rounds_per_level=rounds_per_level)[0]

