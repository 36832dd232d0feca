"""Tiled brute-force nearest-neighbour search (port of ``slr/registration/nn.py``).

The squared distance is the reference's expanded form
``|q|^2 + |t|^2 - 2 q.t``, one ``torch.matmul`` per target tile (a plain
product, as the reference leaves it to XLA outside any kernel), with a
running (min, argmin) over the tiles. Invalid targets get +inf.
"""

from __future__ import annotations

import torch


def nearest_neighbors(query, target, target_valid=None, tile: int = 2048):
    """For each query point, (index, squared distance) of its nearest target.

    query (Q,3), target (T,3), target_valid optional (T,) bool. Returns
    (idx (Q,) int64, d2 (Q,) float32). Ties go to the lowest target index:
    ``min`` returns the first minimum in a tile, and a later tile replaces
    the running best only when strictly closer.
    """
    Q, T = query.shape[0], target.shape[0]
    dev = query.device
    tile = min(tile, T)
    if target_valid is None:
        target_valid = torch.ones(T, dtype=torch.bool, device=dev)
    q2 = torch.sum(query * query, dim=1)
    best_d2 = torch.full((Q,), float("inf"), device=dev)
    best_idx = torch.zeros(Q, dtype=torch.int64, device=dev)
    for base in range(0, T, tile):
        tgt = target[base:base + tile]
        t2 = torch.sum(tgt * tgt, dim=1)
        d2 = q2[:, None] + t2[None, :] - 2.0 * (query @ tgt.T)
        d2 = torch.where(target_valid[base:base + tile][None, :], d2, float("inf"))
        tile_min, tile_arg = torch.min(d2, dim=1)
        take = tile_min < best_d2
        best_d2 = torch.where(take, tile_min, best_d2)
        best_idx = torch.where(take, tile_arg + base, best_idx)
    return best_idx, best_d2
