"""Sorted-band nearest-neighbour search on the card: kernel K8.

Port of ``slr/registration/band.py::band_nn_sorted`` (``_band_kernel``).
Queries and targets are both sorted along the target's principal axis and
cut into tiles. A query tile can only have a target within ``r`` in the
target tiles whose key intervals come within ``r`` of its own, and because
both clouds are sorted those tiles form one contiguous band,
``[jstart, jend)`` with ``jstart = #{thi < qlo - r}`` and
``jend = #{tlo <= qhi + r}`` (``tile_bands``, on the device). The search is
exact within ``r``: it returns each query's nearest valid target when that
lies within ``r``, and a miss (d2 = +inf, idx = -1, point and normal 0)
otherwise. Ties go to the lowest sorted position. Neither the result nor
its tie rule depends on the tile sizes.

Unlike the reference, nothing truncates the band: the kernel walks every
band to its end, whatever its length, so ``b_max`` is accepted for
signature parity and ignored. Distances are ``sum((q - t)^2)`` in float32,
each product and sum rounded once, in the same order in the kernel and in
its plain version, so the two agree bit for bit.

``band_nn_sorted`` takes the plain version for a CPU tensor and launches
K8 for a CUDA tensor, or raises; the recorder's counter ``launches.k8``
(``slr_torch.observability``) counts K8's launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from slr_torch.kernels.build import bind, expect, launch

QT = 128                # queries per K8 block (SLR_BAND_QT in csrc/band_nn.cu)
BIG = 1e9               # coordinate of invalid and padded points
_BLOCK_ELEMS = 1 << 26  # plain version: distances per (query chunk x band) block


class BandTarget(NamedTuple):
    """A target cloud sorted along its principal axis and cut into tiles
    (``slr_torch.registration.band.build_band_target``)."""
    axis: torch.Tensor     # (3,) unit sort axis
    coords: torch.Tensor   # (3, Tp) sorted coords; invalid and padding = BIG
    normals: torch.Tensor  # (3, Tp) sorted normals, float32; padding 0
    index: torch.Tensor    # (Tp,) int64 original index of each sorted target; padding -1
    tlo: torch.Tensor      # (n_t,) lowest key of each tile of Tp / n_t targets
    thi: torch.Tensor      # (n_t,) highest key of each tile


def tile_size(bt: BandTarget) -> int:
    return bt.coords.shape[1] // bt.tlo.shape[0]


def tile_bands(qkey, q_valid, bt: BandTarget, max_corr_dist: float, qt: int = QT):
    """Each query tile's band of target tiles, ``[jstart, jend)`` (int64,
    on the device), from the sorted queries' keys ``qkey`` (Q,). Tiles of
    ``qt`` consecutive queries; the last may be ragged. A tile with no
    valid query has an empty band."""
    Q = qkey.shape[0]
    n_q = -(-Q // qt)
    r = max_corr_dist
    inf = float("inf")
    lo = torch.nn.functional.pad(torch.where(q_valid, qkey, inf), (0, n_q * qt - Q),
                                 value=inf)
    hi = torch.nn.functional.pad(torch.where(q_valid, qkey, -inf), (0, n_q * qt - Q),
                                 value=-inf)
    qlo = lo.reshape(n_q, qt).amin(dim=1)
    qhi = hi.reshape(n_q, qt).amax(dim=1)
    # the tile bounds are sorted, so the counts are binary searches
    jstart = torch.searchsorted(bt.thi, qlo - r, side="left")
    jend = torch.searchsorted(bt.tlo, qhi + r, side="right")
    return jstart, jend


def _winners(qc, q_valid, bt: BandTarget, best, pos, max_corr_dist: float):
    """(d2, point, normal, original index) of each query's winner ``pos``,
    or the miss values where it is farther than ``r`` or the query invalid."""
    hit = q_valid & (best <= max_corr_dist * max_corr_dist)
    safe = pos.clamp(min=0)
    pts = torch.where(hit[:, None], bt.coords[:, safe].T, 0.0)
    nrm = torch.where(hit[:, None], bt.normals[:, safe].T, 0.0)
    return (torch.where(hit, best, float("inf")), pts, nrm,
            torch.where(hit, bt.index[safe], -1))


def band_nn_sorted_reference(qc, q_valid, bt: BandTarget, max_corr_dist: float,
                             qt: int = QT):
    """K8's plain version. Each query's whole band is scored at once, in
    chunks of consecutive query tiles whose (queries x band) distance block
    stays under ``_BLOCK_ELEMS`` floats. Reads the band bounds on the host."""
    Q = qc.shape[1]
    dev = qc.device
    tt = tile_size(bt)
    jstart, jend = tile_bands(bt.axis @ qc, q_valid, bt, max_corr_dist, qt)
    starts, ends = (jstart * tt).tolist(), (jend * tt).tolist()
    lo = (jstart * tt).repeat_interleave(qt)[:Q]
    hi = (jend * tt).repeat_interleave(qt)[:Q]
    best = torch.full((Q,), float("inf"), device=dev)
    pos = torch.full((Q,), -1, dtype=torch.int64, device=dev)
    n_q, a = len(starts), 0
    while a < n_q:
        b, t0, t1 = a + 1, starts[a], ends[a]
        while b < n_q:
            s0, s1 = min(t0, starts[b]), max(t1, ends[b])
            if (b + 1 - a) * qt * max(s1 - s0, 0) > _BLOCK_ELEMS:
                break
            t0, t1, b = s0, s1, b + 1
        q0, q1 = a * qt, min(b * qt, Q)
        a = b
        if t1 <= t0:
            continue
        q, t = qc[:, q0:q1], bt.coords[:, t0:t1]
        dx = q[0][:, None] - t[0][None, :]
        dy = q[1][:, None] - t[1][None, :]
        dz = q[2][:, None] - t[2][None, :]
        d = dx * dx + dy * dy + dz * dz
        p = torch.arange(t0, t1, device=dev)[None, :]
        d = torch.where((p >= lo[q0:q1, None]) & (p < hi[q0:q1, None]), d,
                        float("inf"))
        m, arg = torch.min(d, dim=1)      # the first minimum: lowest position
        take = m < best[q0:q1]
        best[q0:q1] = torch.where(take, m, best[q0:q1])
        pos[q0:q1] = torch.where(take, arg + t0, pos[q0:q1])
    return _winners(qc, q_valid, bt, best, pos, max_corr_dist)


_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
library = bind("band_nn", {   # K8
    "slr_band_nn": (_i32, [_ptr] * 7 + [_i32] * 3 + [ctypes.c_float] + [_ptr] * 4 + [_i32, _ptr]),
})


def launch_band_nn(qc, q_valid, bt: BandTarget, max_corr_dist: float):
    """K8, one launch: a block per tile of ``QT`` sorted queries walks its
    whole band. Returns what ``band_nn_sorted_reference`` returns."""
    Q, Tp = qc.shape[-1], bt.coords.shape[-1]
    f32 = torch.float32
    expect("K8", (qc, (3, Q), f32), (q_valid, (Q,), torch.bool), (bt.coords, (3, Tp), f32),
           (bt.normals, (3, Tp), f32), (bt.index, (Tp,), torch.int64), (bt.axis, (3,), f32))
    if Tp % bt.tlo.shape[0] or Tp >= 2 ** 31 or Q >= 2 ** 31:
        raise ValueError(f"K8: {Tp} targets in {bt.tlo.shape[0]} tiles, {Q} queries")
    jstart, jend = tile_bands(bt.axis @ qc, q_valid, bt, max_corr_dist, QT)
    d2 = torch.empty(Q, device=qc.device)
    pts = torch.empty((Q, 3), device=qc.device)
    nrm = torch.empty((Q, 3), device=qc.device)
    idx = torch.empty(Q, dtype=torch.int64, device=qc.device)
    launch(library(), "slr_band_nn", "K8 band_nn", qc.device,
           qc.data_ptr(), q_valid.data_ptr(), bt.coords.data_ptr(), bt.normals.data_ptr(),
           bt.index.data_ptr(), jstart.data_ptr(), jend.data_ptr(), Q, Tp, tile_size(bt),
           max_corr_dist * max_corr_dist, d2.data_ptr(), pts.data_ptr(), nrm.data_ptr(),
           idx.data_ptr(), counter="launches.k8")
    return d2, pts, nrm, idx


def band_nn_sorted(qc, q_valid, bt: BandTarget, max_corr_dist: float,
                   b_max: int | None = None, qt: int = QT):
    """NN search of SORTED queries ``qc`` (3, Q) (``q_valid`` (Q,) bool;
    any Q) against a ``BandTarget``. Returns (d2 (Q,), point (Q, 3), normal
    (Q, 3), idx (Q,) int64 into the original target order); a query with no
    valid target within ``max_corr_dist`` gets d2 = +inf, idx = -1. CPU
    tensors: the plain version, with query tiles of ``qt``; CUDA: K8, whose
    tile is ``QT``. ``b_max`` is ignored: no band is ever truncated."""
    if qc.device.type == "cpu":
        return band_nn_sorted_reference(qc, q_valid, bt, max_corr_dist, qt=qt)
    return launch_band_nn(qc, q_valid, bt, max_corr_dist)

