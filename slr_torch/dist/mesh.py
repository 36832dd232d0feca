"""Process-group bring-up and the device mesh (port of ``slr/dist/mesh.py``).

The reference is one controller owning a mesh of devices; the port is SPMD:
one process a device, joined by ``torch.distributed`` (NCCL between cards,
Gloo on the CPU). A rank's mesh holds the layout, this rank's coordinate on
each axis and one process group per axis, built on
``torch.distributed.device_mesh.init_device_mesh`` with ``pixel_tile`` the
fast axis, as in the reference.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from slr_torch.device import require_device
from slr_torch.dist import comm

AXES = ("map_block", "pixel_tile")


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device=None, timeout_s: float = 300.0) -> Optional[torch.device]:
    """Joins this process to a job of ``num_processes`` ranks as rank
    ``process_id``; a no-op (returning None) for a single process. Returns
    the rank's device: ``device`` when given with an index or as the CPU,
    else ``cuda:(process_id % torch.cuda.device_count())``.

    ``coordinator`` is ``HOST:PORT`` (rank 0 listens there) or an
    init-method URL such as ``file:///path/store``. ``backend=None`` takes
    NCCL for a CUDA device and Gloo for the CPU; NCCL needs one GPU a rank
    on this host (``LOCAL_WORLD_SIZE`` ranks, else all of them) and raises
    otherwise, so ranks share a card only under a ``backend="gloo"`` the
    caller names. Every collective of the job times out after
    ``timeout_s`` seconds."""
    if num_processes is None or num_processes <= 1:
        return None
    if coordinator is None or process_id is None:
        raise ValueError("a job of several processes needs a coordinator and this "
                         "process's id")
    dev = require_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        here = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
        if dev.type != "cuda" or here > torch.cuda.device_count():
            raise RuntimeError(
                f"NCCL needs one GPU a rank: {here} ranks on this host, "
                f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} GPUs; "
                "pass backend='gloo' for ranks that share a card")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=timeout_s))
    return dev


@dataclass(frozen=True)
class Mesh:
    """A (map_block, pixel_tile) layout seen from one rank: ``shape`` maps
    each axis to its size, ``coords`` to this rank's index on it, ``groups``
    to the axis's process group (None on a trivial mesh, where every
    collective is an identity)."""
    shape: dict
    coords: dict
    groups: dict


def make_mesh(pixel_tiles: int = 0, map_blocks: int = 0) -> Mesh:
    """Mesh with axes ('map_block', 'pixel_tile') over the world.

    Defaults: every rank on the pixel_tile axis; one size given, the other
    fills the world. The product must equal the world's size: a larger
    product fails the reference's assertion; a world larger than the
    layout raises ``ValueError`` (the reference takes its first devices).
    Every rank must call this, in the same order as every other group
    creation."""
    n = comm.world()[1]
    if pixel_tiles <= 0 and map_blocks <= 0:
        pixel_tiles, map_blocks = n, 1
    elif pixel_tiles <= 0:
        pixel_tiles = n // map_blocks
    elif map_blocks <= 0:
        map_blocks = n // pixel_tiles
    if 0 < pixel_tiles * map_blocks < n:
        raise ValueError(f"a world of {n} ranks is larger than the layout of "
                         f"{map_blocks} map blocks x {pixel_tiles} pixel tiles "
                         f"({map_blocks * pixel_tiles} ranks)")
    assert pixel_tiles * map_blocks == n, (pixel_tiles, map_blocks, n)
    shape = {"map_block": map_blocks, "pixel_tile": pixel_tiles}
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(shape=shape, coords=dict.fromkeys(AXES, 0),
                    groups=dict.fromkeys(AXES))
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (map_blocks, pixel_tiles), mesh_dim_names=AXES)
    coords = dict(zip(AXES, dm.get_coordinate()))
    groups = {a: dm.get_group(a) for a in AXES}
    for a in AXES:   # the group's ranks run along the axis
        assert dist.get_group_rank(groups[a], dist.get_rank()) == coords[a], a
    return Mesh(shape=shape, coords=coords, groups=groups)
