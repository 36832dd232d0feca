"""Sorted-band nearest-neighbour search (port of ``slr/registration/band.py``).

Both clouds are projected on the target's principal axis and sorted along
it once; tiles of sorted queries then search only the contiguous band of
sorted target tiles whose keys come within the radius (kernel K8,
``slr_torch.kernels.band_nn``). Exact within the radius.

Divergences from the reference, by design: the band is never truncated
(``b_max`` is accepted and ignored, so ``suggest_b_max`` is only a
diagnostic, and it now honours ``target_valid``); the target normals stay
float32 (the reference rounds them to bf16 for its one-hot extraction); and
distances are ``sum((q - t)^2)``, not the expanded form, so where the two
nearest targets lie within the expanded form's rounding the port may pick
the other one.
"""

from __future__ import annotations

import torch

from slr_torch.kernels.band_nn import (
    BIG, QT, BandTarget, band_nn_sorted, band_nn_sorted_reference, tile_bands)

TT = 128        # targets per tile

__all__ = ["BIG", "QT", "TT", "BandTarget", "band_nearest_neighbors",
           "band_nn_sorted", "band_nn_sorted_reference", "band_widths",
           "build_band_target", "principal_axis", "suggest_b_max", "tile_bands"]


def principal_axis(pts, valid, iters: int = 8):
    """Leading eigenvector of the valid points' covariance by power
    iteration, sign-canonicalised (largest-magnitude component positive)."""
    w = valid.to(torch.float32)
    ws = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(pts * w[:, None], dim=0) / ws
    X = (pts - mu) * w[:, None]
    C = X.T @ (pts - mu) / ws + 1e-9 * torch.eye(3, device=pts.device)
    v = torch.full((3,), 0.57735027, device=pts.device)
    for _ in range(iters):
        v = C @ v
        v = v / torch.clamp(torch.linalg.norm(v), min=1e-20)
    s = torch.sign(v.gather(0, torch.argmax(v.abs()).reshape(1)))
    return v * torch.where(s == 0, 1.0, s)


def build_band_target(tgt, tgt_normals=None, tgt_valid=None, tt: int = TT) -> BandTarget:
    """Sort the target (T, 3) along its principal axis (stable: equal keys
    keep their original order) and cut it into tiles of ``tt``. Invalid
    targets sort last with coordinates ``BIG``; the padding to a whole tile
    too."""
    T = tgt.shape[0]
    dev = tgt.device
    if tgt_valid is None:
        tgt_valid = torch.ones(T, dtype=torch.bool, device=dev)
    if tgt_normals is None:
        tgt_normals = torch.zeros_like(tgt)
    axis = principal_axis(tgt, tgt_valid)
    key = torch.where(tgt_valid, tgt @ axis, 1e38)
    key_s, order = torch.sort(key, stable=True)
    pad = -T % tt

    def sorted_rows(a, fill):
        return torch.nn.functional.pad(a[order].T, (0, pad), value=fill).contiguous()

    coords = sorted_rows(torch.where(tgt_valid[:, None], tgt, BIG), BIG)
    normals = sorted_rows(tgt_normals.to(torch.float32), 0.0)
    index = torch.nn.functional.pad(order, (0, pad), value=-1)
    kt = torch.nn.functional.pad(key_s, (0, pad), value=3e38).reshape(-1, tt)
    return BandTarget(axis=axis, coords=coords, normals=normals, index=index,
                      tlo=kt[:, 0].contiguous(), thi=kt[:, -1].contiguous())


def band_widths(query, q_valid, bt: BandTarget, max_corr_dist: float, qt: int = QT):
    """Per-query-tile band lengths (in target tiles) of the queries sorted
    along ``bt.axis``: what the reference's ``b_max`` had to bound."""
    key = torch.where(q_valid, query @ bt.axis, float("inf"))
    k = torch.sort(key).values
    jstart, jend = tile_bands(k, torch.isfinite(k), bt, max_corr_dist, qt)
    return torch.clamp(jend - jstart, min=0)


def suggest_b_max(query, target, max_corr_dist: float, slack: float = 1.5,
                  qt: int = QT, tt: int = TT, target_valid=None) -> int:
    """The reference's static band cap: the widest band at the current query
    positions, times ``slack``, plus 2 tiles. The port never truncates a
    band, so nothing needs this; it reads the widths on the host."""
    bt = build_band_target(target, tgt_valid=target_valid, tt=tt)
    w = band_widths(query, torch.ones(query.shape[0], dtype=torch.bool,
                                      device=query.device), bt, max_corr_dist, qt)
    wmax = int(w.max())
    return max(1, min(int(slack * wmax) + 2, int(bt.tlo.shape[0])))


def band_nearest_neighbors(query, target, target_normals=None, target_valid=None,
                           max_corr_dist: float = 10.0, b_max: int | None = None,
                           qt: int = QT, tt: int = TT):
    """Exact-within-radius NN in the ORIGINAL query order: (idx (Q,) int64,
    d2 (Q,)), with idx = -1 and d2 = +inf where no valid target lies within
    ``max_corr_dist``. ``b_max`` is ignored (no band is truncated)."""
    bt = build_band_target(target, target_normals, target_valid, tt=tt)
    _, order = torch.sort(query @ bt.axis, stable=True)
    qc = query[order].T.contiguous()
    qv = torch.ones(query.shape[0], dtype=torch.bool, device=query.device)
    d2s, _, _, idxs = band_nn_sorted(qc, qv, bt, max_corr_dist, qt=qt)
    idx, d2 = torch.empty_like(idxs), torch.empty_like(d2s)
    idx[order] = idxs
    d2[order] = d2s
    return idx, d2
