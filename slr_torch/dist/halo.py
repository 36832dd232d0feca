"""Halo exchange over a mesh axis (port of ``slr/dist/halo.py``).

The spatial repair couples neighbouring pixels; with the image rows sharded
over ``pixel_tile`` each tile needs its neighbours' border rows. One ring
exchange (``comm.ring_exchange``: a send to each neighbour and a receive
from each) moves ``halo`` rows each way; the rows that wrap around the
ring are zeroed at the global borders, as the reference's full rotations
are masked.
"""

from __future__ import annotations

import torch

from slr_torch.dist import comm


def halo_exchange_rows(x, mesh, axis: str, halo: int):
    """x: this rank's (H_local, W) shard along ``axis``. Returns
    (H_local + 2 * halo, W): the previous rank's last ``halo`` rows, x, the
    next rank's first ``halo`` rows, with zeros past the image's first and
    last rows. On an axis of one rank it only pads."""
    n, idx = mesh.shape[axis], mesh.coords[axis]
    if not 1 <= halo <= x.shape[0]:
        raise ValueError(f"halo must be 1..{x.shape[0]} rows (the shard's height), "
                         f"got {halo}")
    if n == 1:
        zeros = x.new_zeros((halo,) + tuple(x.shape[1:]))
        return torch.cat([zeros, x, zeros])
    top, bottom = comm.ring_exchange(x[:halo], x[-halo:], mesh.groups[axis])
    if idx == 0:
        top = torch.zeros_like(top)
    if idx == n - 1:
        bottom = torch.zeros_like(bottom)
    return torch.cat([top, x, bottom])
