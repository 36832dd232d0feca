"""Point-cloud outlier filters (port of ``slr/registration/filters.py``).

The scan clean-up between reconstruction and registration or fusion, on the
voxel hash of ``slr_torch.registration.voxel``: each query looks at the
bucketed points of the 27 voxels around its own.

- ``knn_mean_distance``: mean distance to the k nearest neighbours.
- ``statistical_outlier_removal`` (SOR): drop points whose mean k-NN
  distance exceeds mean + std_ratio * std over the cloud.
- ``radius_outlier_removal`` (ROR): drop points with fewer than
  ``min_neighbors`` others inside ``radius``.

Exact wherever the relevant neighbour distances are within one voxel edge
and no bucket overflows. Queries go through in chunks of ``chunk`` rows,
which bounds the (chunk, 27 * bucket_cap) candidate block in memory.
"""

from __future__ import annotations

import torch

from slr_torch.registration.voxel import (
    _INVALID_VID, _pack_vid, _voxel_coords, build_voxel_hash)

_NBRS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


def _candidate_d2(q, qidx, points, table, row_ids, lo, voxel_size: float):
    """(Q, 3) queries -> (Q, 27 * bucket_cap) squared distances to the hash's
    candidates; a query's own index and empty slots are +inf."""
    vq = _voxel_coords(q, voxel_size)
    ones = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    last = row_ids.shape[0] - 1
    outs = []
    for off in _NBRS:
        vid = _pack_vid(vq + torch.tensor(off, dtype=torch.int32, device=q.device),
                        lo, ones)
        row = torch.searchsorted(row_ids, vid).clamp(0, last)
        hit = (row_ids[row] == vid) & (vid != _INVALID_VID)
        cand = torch.where(hit[:, None], table[row], -1)            # (Q, cap)
        d2 = torch.sum((points[cand.clamp(min=0)] - q[:, None, :]) ** 2, dim=-1)
        outs.append(torch.where((cand < 0) | (cand == qidx[:, None]), float("inf"), d2))
    return torch.cat(outs, dim=1)


def _chunked(points, valid, voxel_size: float, bucket_cap: int, chunk: int, reduce):
    """``reduce(d2)`` of every query's candidate block, ``chunk`` queries at
    a time; invalid queries are parked far away (no candidates)."""
    table, row_ids, lo = build_voxel_hash(points, valid, voxel_size, bucket_cap)
    q = torch.where(valid[:, None], points, 1e9)
    qi = torch.arange(points.shape[0], dtype=torch.int32, device=points.device)
    return torch.cat([
        reduce(_candidate_d2(q[s:s + chunk], qi[s:s + chunk], points, table, row_ids,
                             lo, voxel_size))
        for s in range(0, points.shape[0], chunk)])


def knn_mean_distance(points, valid, voxel_size: float, k: int = 8,
                      bucket_cap: int = 16, chunk: int = 16384):
    """Mean distance from each point to its k nearest neighbours in the
    27-voxel neighbourhood. Invalid points and points with no neighbour
    found get +inf."""
    def mean_k(d2):
        dk2 = torch.topk(d2, min(k, d2.shape[1]), dim=1, largest=False).values
        fin = torch.isfinite(dk2)
        cnt = torch.sum(fin, dim=1)
        s = torch.sum(torch.sqrt(torch.where(fin, dk2, 0.0)), dim=1)
        return torch.where(cnt > 0, s / cnt.clamp(min=1), float("inf"))

    md = _chunked(points, valid, voxel_size, bucket_cap, chunk, mean_k)
    return torch.where(valid, md, float("inf"))


def statistical_outlier_removal(points, valid, voxel_size: float, k: int = 8,
                                std_ratio: float = 2.0, bucket_cap: int = 16,
                                chunk: int = 16384):
    """PCL-style SOR: keep the points whose mean k-NN distance is at most
    mean + std_ratio * std over the cloud. Returns the kept mask."""
    md = knn_mean_distance(points, valid, voxel_size, k=k, bucket_cap=bucket_cap,
                           chunk=chunk)
    fin = valid & torch.isfinite(md)
    n = torch.sum(fin).clamp(min=1)
    mean = torch.sum(torch.where(fin, md, 0.0)) / n
    var = torch.sum(torch.where(fin, (md - mean) ** 2, 0.0)) / n
    return fin & (md <= mean + std_ratio * torch.sqrt(var))


def radius_outlier_removal(points, valid, radius: float, min_neighbors: int = 4,
                           bucket_cap: int = 16, chunk: int = 16384):
    """Keep the points with at least ``min_neighbors`` others inside
    ``radius``. The voxel edge is ``radius``, so the 27 voxels cover the
    ball; counts saturate at 27 * bucket_cap."""
    r2 = radius * radius
    cnt = _chunked(points, valid, radius, bucket_cap, chunk,
                   lambda d2: torch.sum(d2 <= r2, dim=1))
    return valid & (cnt >= min_neighbors)
