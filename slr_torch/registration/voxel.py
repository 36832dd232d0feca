"""Voxel-grid utilities (port of ``slr/registration/voxel.py``): the voxel
merge of fusion and the voxel-hash nearest neighbours.

``voxel_downsample`` averages the points (and attributes) of each occupied
voxel into a fixed-capacity buffer, each voxel's sum taken in index order
by an ordered segment sum (no float atomics, so the same bits in every
call).

The hash is ICP's CPU alternative to the exact search: the target is
bucketed once into a static voxel grid with at most ``bucket_cap`` points a
voxel, and a query looks only at the 27 voxels around its own. With the
voxel edge equal to the correspondence radius, every target within that
radius lies in those voxels; in clouds denser than ``bucket_cap`` points a
voxel the match is the nearest of the bucket's sample.

Fixed shapes, as the reference: the table has one row per input point (the
most voxels there can be), addressed by ``searchsorted`` on the sorted
unique voxel ids.
"""

from __future__ import annotations

import torch

# 10 bits per axis: a 1024^3-voxel window anchored at the cloud's own
# minimum voxel. Coordinates outside it map to the invalid sentinel (bit
# 30, above the 30 coordinate bits), never onto another voxel.
_VOX_BITS = 10
_VOX_N = 1 << _VOX_BITS
_INVALID_VID = 0x40000000
_PAD_VID = 0x7FFFFFFF      # row ids past the unique ones
_TAIL = 1024               # points a discarded segment of voxel_downsample holds


def _voxel_coords(points, voxel_size: float):
    """floor(points / voxel_size) as int32, with an IEEE division on every
    device (a Python divisor would be a reciprocal multiply on CUDA)."""
    size = torch.full((), voxel_size, dtype=torch.float32, device=points.device)
    return torch.floor(points / size).to(torch.int32)


def _voxel_origin(v, valid):
    """Per-axis minimum voxel coordinate over the valid points: the anchor
    of the packing window."""
    return torch.where(valid[:, None], v, 1 << 30).amin(dim=0)


def _pack_vid(v, lo, valid):
    """Window-relative voxel coordinates packed into a 30-bit id; invalid
    points and coordinates outside the window get the sentinel."""
    w = v - lo
    inr = ((w >= 0) & (w < _VOX_N)).all(dim=-1)
    vid = w[:, 0] | (w[:, 1] << _VOX_BITS) | (w[:, 2] << (2 * _VOX_BITS))
    return torch.where(valid & inr, vid, _INVALID_VID)


def build_voxel_hash(points, valid, voxel_size: float, bucket_cap: int = 8):
    """Static voxel-grid hash with bounded buckets.

    points (N, 3), valid (N,) bool. Returns (table (N, bucket_cap) int32:
    point indices, -1 padded, row k for the k-th smallest unique voxel id;
    row_ids (N,) int32: the sorted unique ids, padded with 0x7FFFFFFF;
    lo (3,) int32: the window anchor that queries are packed against). A
    bucket keeps the first ``bucket_cap`` points of its voxel in index
    order. Only the kept entries are written, so the table is the same on
    every device.
    """
    N = points.shape[0]
    dev = points.device
    v = _voxel_coords(points, voxel_size)
    lo = _voxel_origin(v, valid)
    vid = _pack_vid(v, lo, valid)
    vid_s, order = torch.sort(vid, stable=True)
    first = torch.ones(N, dtype=torch.bool, device=dev)
    first[1:] = vid_s[1:] != vid_s[:-1]
    seg = torch.cumsum(first.to(torch.int32), 0) - 1          # row of each point
    ar = torch.arange(N, device=dev)
    run_start = torch.cummax(torch.where(first, ar, 0), 0).values
    pos = ar - run_start                                      # rank in its voxel
    keep = pos < bucket_cap
    table = torch.full((N, bucket_cap), -1, dtype=torch.int32, device=dev)
    table[seg[keep], pos[keep]] = order[keep].to(torch.int32)
    row_ids = torch.sort(torch.where(first, vid_s, _PAD_VID)).values
    return table, row_ids, lo


def voxel_hash_nn(query, points, table, row_ids, lo, voxel_size: float,
                  bucket_cap: int = 8):
    """Nearest bucketed point in the 27-neighbourhood of each query's voxel.

    Returns (idx (Q,) int32, -1 when no candidate, including queries
    outside the window; d2 (Q,) float32, inf then). Within a bucket the
    first nearest wins; across the 27 voxels, visited dx, dy, dz in (-1, 0,
    1), a later voxel wins only when strictly nearer.
    """
    Q = query.shape[0]
    dev = query.device
    vq = _voxel_coords(query, voxel_size)
    ones = torch.ones(Q, dtype=torch.bool, device=dev)
    best_d2 = torch.full((Q,), float("inf"), device=dev)
    best_i = torch.full((Q,), -1, dtype=torch.int32, device=dev)
    last = row_ids.shape[0] - 1
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                off = torch.tensor([dx, dy, dz], dtype=torch.int32, device=dev)
                vid = _pack_vid(vq + off, lo, ones)
                row = torch.searchsorted(row_ids, vid).clamp(0, last)
                # the sentinel may itself be a row (masked points): an
                # out-of-window query must not match it
                hit = (row_ids[row] == vid) & (vid != _INVALID_VID)
                cand = torch.where(hit[:, None], table[row], -1)   # (Q, cap)
                cpts = points[cand.clamp(min=0)]                   # (Q, cap, 3)
                d2 = torch.sum((cpts - query[:, None, :]) ** 2, dim=-1)
                d2 = torch.where(cand >= 0, d2, float("inf"))
                j = torch.argmin(d2, dim=1, keepdim=True)   # the first minimum
                dmin = torch.gather(d2, 1, j)[:, 0]
                imin = torch.gather(cand, 1, j)[:, 0]
                take = dmin < best_d2
                best_d2 = torch.where(take, dmin, best_d2)
                best_i = torch.where(take, imin, best_i)
    return best_i, best_d2


def voxel_downsample(points, valid, voxel_size: float, capacity: int, attrs=None):
    """Average the points (and optional attributes) that fall in one voxel.

    points (N, 3), valid (N,) bool, attrs (N, A) or None. Returns
    (out_pts (capacity, 3), out_valid (capacity,) bool, out_attrs
    (capacity, A) or None, n_voxels: every occupied voxel, those past
    ``capacity`` too, which are dropped). Slot k holds the voxel with the
    k-th smallest packed id: a stable sort by id, so within a voxel the
    points sum in index order. Points outside the 1024-voxel window at the
    cloud's minimum voxel are dropped, never aliased onto another voxel.
    """
    N = points.shape[0]
    dev = points.device
    v = _voxel_coords(points, voxel_size)
    vid = _pack_vid(v, _voxel_origin(v, valid), valid)
    vid_s, order = torch.sort(vid, stable=True)
    val_s = vid_s != _INVALID_VID           # valid and inside the window
    first = torch.ones(N, dtype=torch.bool, device=dev)
    first[1:] = vid_s[1:] != vid_s[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    # the points past the last slot (overflowing or invalid; they sort last)
    # go to discarded segments of at most _TAIL points each: a segment is
    # summed in order by one thread on the card, so one bucket of them all
    # would take the longest serial sum. The segments stay non-decreasing.
    ar = torch.arange(N, device=dev)
    seg = torch.where(val_s & (seg < capacity), seg, capacity + ar // _TAIL)
    w = val_s[:, None].to(torch.float32)
    cols = [points[order] * w, w]
    if attrs is not None:
        cols.insert(1, attrs[order] * w)
    offsets = torch.searchsorted(seg, torch.arange(capacity + N // _TAIL + 2, device=dev))
    sums = torch.segment_reduce(torch.cat(cols, dim=1), "sum", offsets=offsets,
                                axis=0, unsafe=True)[:capacity]
    cnt = sums[:, -1:]
    denom = torch.where(cnt > 0, cnt, 1.0)
    out_attrs = None if attrs is None else sums[:, 3:-1] / denom
    return sums[:, :3] / denom, cnt[:, 0] > 0, out_attrs, torch.sum(first & val_s)
