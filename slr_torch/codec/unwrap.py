"""Phase unwrapping (port of ``slr/codec/unwrap.py``).

Temporal: ``unwrap_temporal`` combines the wrapped phase with the Gray-code
stripe index. Spatial, two repairs of a temporally unwrapped map, both
plain torch here and the plain versions of the kernels in
``slr_torch/kernels/{unwrap_scan,wavefront}.py``:

- strict-consensus voting (``propagation_step``, ``spatial_quality_unwrap``):
  each sweep lets every valid 4-neighbour vote an integer fringe-order
  correction, and a pixel snaps when at least 3 cast the same non-zero vote.
  It repairs isolated single-pixel order errors.
- the quality-ordered wavefront (``quality_guided_unwrap``,
  ``quality_guided_repair``): over descending quality thresholds, directional
  line scans carry unwrapped phase from done pixels into eligible ones. It
  repairs multi-pixel blobs, or unwraps a phase-only map from one seed.

A directional pass is an inclusive scan of a 3-field monoid (tag, ps, pv)
along each line (``slr/kernels/wavefront.py:12-20``). Torch has no
associative scan, so the plain pass is a Hillis-Steele scan built from
shifts along the axis: step s composes each element with the one s places
upstream, s = 1, 2, 4, ... That is the association the CUDA kernel uses, so
the two agree to the last bit where their divisions do.

Float rules shared with the kernels: the divisor 2 pi is a device tensor,
so CUDA divides (it would multiply by the reciprocal of a Python scalar);
``torch.round`` rounds half to even, as ``rintf`` does; and ``a + 2 pi k``
rounds the product and then the sum, which the kernels keep with
``__fmul_rn``/``__fadd_rn``.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi
# (dy, dx) of the neighbour shifts, in the vote's tie order: the neighbour
# above, below, left, right
_NEIGHBOURS = ((1, 0), (-1, 0), (0, 1), (0, -1))
_PASSES = ((1, False), (1, True), (0, False), (0, True))


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


def _cycles(x):
    """round(x / 2pi), with an IEEE division on every device."""
    return torch.round(x / torch.full((), TWO_PI, dtype=torch.float32,
                                      device=x.device))


# --- strict-consensus voting ------------------------------------------------


def _shift_zero(a, dy: int, dx: int):
    """``out[i, j] = a[i - dy, j - dx]``, zero where that lies outside
    (|dy|, |dx| <= 1): a roll without wraparound."""
    H, W = a.shape
    out = torch.zeros_like(a)
    dst_r, src_r = slice(max(dy, 0), H + min(dy, 0)), slice(max(-dy, 0), H - max(dy, 0))
    dst_c, src_c = slice(max(dx, 0), W + min(dx, 0)), slice(max(-dx, 0), W - max(dx, 0))
    out[dst_r, dst_c] = a[src_r, src_c]
    return out


def propagation_step(Phi_c, q_c, mask):
    """One strict-consensus repair sweep; returns (Phi, q_c).

    Each valid 4-neighbour votes k = round((Phi_nb - Phi_c) / 2pi); the
    pixel moves by the vote that most neighbours share (the first best in
    the order above, below, left, right) when at least 3 share it and it is
    not 0. ``q_c`` rides along untouched: the vote is quality-blind.
    """
    fmask = mask.to(torch.float32)
    masked = Phi_c * fmask
    votes, valids = [], []
    for dy, dx in _NEIGHBOURS:
        votes.append(_cycles(_shift_zero(masked, dy, dx) - Phi_c))
        valids.append(_shift_zero(fmask, dy, dx) > 0.5)
    best_count = torch.zeros_like(Phi_c)
    best_k = torch.zeros_like(Phi_c)
    for i in range(4):
        count_i = torch.zeros_like(Phi_c)
        for j in range(4):
            count_i = count_i + (valids[j] & (votes[j] == votes[i])).to(torch.float32)
        better = valids[i] & (votes[i] != 0) & (count_i > best_count)
        best_count = torch.where(better, count_i, best_count)
        best_k = torch.where(better, votes[i], best_k)
    take = mask & (best_count >= 3.0)
    return torch.where(take, Phi_c + TWO_PI * best_k, Phi_c), q_c


def spatial_quality_unwrap(Phi, quality, mask, iters: int = 8):
    """``iters`` strict-consensus sweeps of ``propagation_step``.

    Phi: (H,W) absolute phase; quality: (H,W), unused by the vote (kept for
    the kernels' signature); mask: (H,W) bool. Returns the repaired Phi.
    """
    Phi = Phi.to(torch.float32)
    for _ in range(iters):
        Phi, _ = propagation_step(Phi, quality, mask)
    return Phi


# --- quality-guided wavefront -----------------------------------------------


def _compose(tx, psx, pvx, ty, psy, pvy):
    """The monoid's 'x then y' (x upstream of y). Tags: 2 CONST(pv) emits
    pv; 1 CHAIN(ps, pv) maps an arriving x to pv + 2pi round((x - ps)/2pi);
    0 KILL blocks."""
    y_chain = ty == 1
    pv_c = pvy + TWO_PI * _cycles(pvx - psy)
    tag = torch.where(y_chain, tx, ty)
    ps = torch.where(y_chain & (tx == 1), psx, psy)
    pv = torch.where(y_chain & (tx != 0), pv_c, pvy)
    return tag, ps, pv


def directional_pass(phi, elig, Phi, done, axis: int, reverse: bool):
    """One growth pass along ``axis`` (1: rows, 0: columns), upstream at
    lower indices, or higher ones when ``reverse``: the plain version of
    kernel K5. Eligible pixels that a done pixel reaches through eligible
    ones take its phase, unwrapped pixel to pixel. Returns (Phi, done)."""
    tag = torch.where(done, 2, torch.where(elig, 1, 0)).to(torch.int32)
    ps = phi
    pv = torch.where(done, Phi, phi)
    n = phi.shape[axis]
    s = 1
    while s < n:
        fields = (tag, ps, pv)
        if reverse:   # element i composes with i + s; the last s keep
            head = _compose(*(f.narrow(axis, s, n - s) for f in fields),
                            *(f.narrow(axis, 0, n - s) for f in fields))
            tail = [f.narrow(axis, n - s, s) for f in fields]
        else:         # element i composes with i - s; the first s keep
            head = [f.narrow(axis, 0, s) for f in fields]
            tail = _compose(*(f.narrow(axis, 0, n - s) for f in fields),
                            *(f.narrow(axis, s, n - s) for f in fields))
        tag, ps, pv = (torch.cat(pair, axis) for pair in zip(head, tail))
        s <<= 1
    reached = elig & ~done & (tag == 2)
    return torch.where(reached, pv, Phi), done | reached


def wavefront(phi, quality, mask, Phi_init, trust, levels: int,
              rounds_per_level: int, pass_fn):
    """The wavefront loop shared by the plain route and the kernel route
    (``pass_fn``: ``directional_pass`` or its kernel wrapper).

    Seed: the given trusted pixels (repair mode), or else the first
    highest-quality masked pixel. Thresholds: ``levels`` quantiles of the
    masked quality, descending from 1 - 1/levels to 0, linear
    interpolation; each level runs ``rounds_per_level`` rounds of the four
    passes (left to right, right to left, top down, bottom up). No value
    leaves the device. Returns (Phi, reached).
    """
    phi = phi.to(torch.float32)
    q = torch.where(mask, quality, 0.0).to(torch.float32)
    if Phi_init is None:
        seed = torch.argmax(torch.where(mask, q, -1.0))
        done = torch.zeros(phi.numel(), dtype=torch.bool, device=phi.device)
        done = done.index_fill(0, seed.reshape(1), True).reshape(phi.shape) & mask
        Phi = phi
    else:
        if trust is None:
            raise ValueError("repair mode needs a trust mask")
        done = trust & mask
        Phi = Phi_init.to(torch.float32)
    qs = torch.nanquantile(
        torch.where(mask, q, torch.nan),
        torch.linspace(1.0 - 1.0 / levels, 0.0, levels, device=phi.device))
    for li in range(levels):
        elig = mask & (q >= qs[li])
        for _ in range(rounds_per_level):
            for axis, rev in _PASSES:
                Phi, done = pass_fn(phi, elig, Phi, done, axis, rev)
    return Phi, done


def quality_guided_unwrap(phi, quality, mask, Phi_init=None, trust=None,
                          levels: int = 4, rounds_per_level: int = 2):
    """Quality-ordered wavefront unwrap, plain torch.

    Phase-only (``Phi_init`` None): one seed anchors the absolute phase of
    the wrapped ``phi``. Repair (``Phi_init`` and ``trust``): trusted pixels
    keep ``Phi_init`` and act as sources; every pixel reached re-derives its
    fringe order from them, the others keep ``Phi_init``. Returns (Phi,
    reached).
    """
    return wavefront(phi, quality, mask, Phi_init, trust, levels,
                     rounds_per_level, directional_pass)


def repair_trust(Phi, quality, mask, trust_quantile: float = 0.5):
    """(wrapped phase, trust): the pixels at or above the masked quality's
    ``trust_quantile`` anchor a repair."""
    thr = torch.nanquantile(torch.where(mask, quality, torch.nan),
                            trust_quantile)
    return torch.remainder(Phi, TWO_PI), mask & (quality >= thr)


def quality_guided_repair(Phi, quality, mask, trust_quantile: float = 0.5,
                          levels: int = 4, rounds_per_level: int = 2):
    """Blob-capable order-error repair of a temporally unwrapped map: the
    fringe order below the trusted quantile is re-derived by the wavefront
    from the pixels above it; unreached pixels keep their value."""
    phi, trust = repair_trust(Phi, quality, mask, trust_quantile)
    return quality_guided_unwrap(phi, quality, mask, Phi_init=Phi, trust=trust,
                                 levels=levels, rounds_per_level=rounds_per_level)[0]
