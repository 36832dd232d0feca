"""Strict-consensus phase repair on the card: kernels K3 and K4.

Port of ``slr/kernels/unwrap_scan.py``. Both kernels run ``iters`` sweeps of
``slr_torch.codec.unwrap.propagation_step`` and return what
``spatial_quality_unwrap`` returns, bit for bit:

- K3, ``launch_vote_resident`` (``quality_unwrap_pallas``): the whole map
  resident in registers for every sweep, one tile a block in one
  cooperative launch; every few sweeps (K3_HALO in csrc/unwrap.cu) each
  tile trades the ring of its owned cells with the tiles around it through
  a small exchange buffer, not the map. Each launch takes its own buffer
  from the caching allocator (so launches that overlap, as CUDA graphs
  replayed on two streams do, share nothing). A map whose tiles
  (``resident_tiles``) exceed one wave of blocks is refused with
  ``ValueError``.
- K4, ``launch_vote_tiled`` (``quality_unwrap_tiled``): temporal blocking.
  Each block loads a tile with a halo of h cells into registers (a run of
  rows of one column a thread, warps side by side), runs h sweeps there
  and writes the tile's interior; h is at most ``MAX_HALO``, so more sweeps
  take one launch per chunk of h. The tile's shape is the kernel's own:
  the reference's ``tile_h`` is accepted and ignored.

``quality_unwrap`` keeps the reference's dispatch, so a shape takes the same
kernel as there: K4 when the padded map 3 * round_up(H, 8) *
round_up(W, 128) * 4 B exceeds 12 MiB, else K3; and K4 also for a map
within the budget whose tiles exceed one wave of K3's blocks on this card
(a 32 x 32768 map: 1,130 tiles on an H100, which holds 1,056). Both return
the plain sweep's bits, so the route changes no result. Each wrapper takes the
plain version for a CPU tensor and launches for a CUDA tensor, or raises.
``quality`` is unused by the vote; the kernels do not read it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from slr_torch.codec.unwrap import spatial_quality_unwrap
from slr_torch.kernels.build import bind, check_status, expect, launch

RESIDENT_BUDGET = 12 * 1024 * 1024   # the reference's VMEM budget (bytes)
MAX_HALO = 8                         # SLR_MAX_HALO in csrc/unwrap.cu


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def takes_tiled(H: int, W: int) -> bool:
    """The reference's rule: K4 for maps whose padded Phi, q and mask
    exceed the 12 MiB budget."""
    return 3 * _round_up(H, 8) * _round_up(W, 128) * 4 > RESIDENT_BUDGET


def resident_tiles(H: int, W: int, ow: int, oh: int) -> int:
    """The tiles (blocks) of K3's one launch on an (H, W) map, each owning
    ow x oh cells (``resident_layout``)."""
    return -(-W // ow) * -(-H // oh)


_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
library = bind("unwrap", {   # K3, K4 and K5
    "slr_vote_resident": (_i32, [_ptr] * 4 + [_i32] * 4 + [_ptr]),
    "slr_vote_resident_layout": (_i32, [_i32, _ptr]),
    "slr_vote_tiled": (_i32, [_ptr] * 3 + [_i32] * 4 + [_ptr]),
    "slr_wavefront_pass": (_i32, [_ptr] * 6 + [_i32] * 5 + [_ptr]),
    "slr_wavefront_cycles_check": (_i32, [_ptr, _i32, _ptr]),
})


@functools.cache
def resident_layout(device: int) -> tuple[int, int, int, int]:
    """K3 on a card: (tiles one wave holds, 32-bit words of exchange buffer
    a tile, cells a tile owns across, down), from the library."""
    lib = library()
    layout = (ctypes.c_int * 4)()
    check_status(lib, "K3 layout", lib.slr_vote_resident_layout(device, layout))
    return tuple(layout)


def launch_vote_resident(Phi, mask, iters: int):
    """K3: ``iters`` (>= 1) sweeps in one cooperative launch. Raises
    ``ValueError`` for a map whose tiles exceed one wave of blocks on this
    card (no fall-back), and ``RuntimeError`` if the card refuses the
    cooperative launch."""
    H, W = Phi.shape
    expect("K3", (Phi, (H, W), torch.float32), (mask, (H, W), torch.bool))
    dev = Phi.device.index
    wave, words, ow, oh = resident_layout(dev)
    tiles = resident_tiles(H, W, ow, oh)
    if tiles > wave:
        raise ValueError(f"K3 holds at most {wave} tiles of {ow}x{oh} cells in one wave on "
                         f"this card; a {H}x{W} map needs {tiles}")
    # this launch's counters and rings (the kernel zeroes its counters)
    exchange = torch.empty(tiles * words, dtype=torch.int32, device=Phi.device)
    out = torch.empty_like(Phi)
    launch(library(), "slr_vote_resident", "K3 vote_resident", Phi.device,
           Phi.data_ptr(), mask.data_ptr(), out.data_ptr(), exchange.data_ptr(), H, W, iters,
           counter="launches.k3")
    return out


def launch_vote_tiled(Phi, mask, sweeps: int):
    """K4, one launch: ``sweeps`` (1..MAX_HALO) sweeps over tiles with a
    halo of ``sweeps``."""
    H, W = Phi.shape
    expect("K4", (Phi, (H, W), torch.float32), (mask, (H, W), torch.bool))
    if not 1 <= sweeps <= MAX_HALO:
        raise ValueError(f"K4 takes 1..{MAX_HALO} sweeps a launch, got {sweeps}")
    out = torch.empty_like(Phi)
    launch(library(), "slr_vote_tiled", "K4 vote_tiled", Phi.device,
           Phi.data_ptr(), mask.data_ptr(), out.data_ptr(), H, W, sweeps,
           counter="launches.k4")
    return out


def _prepare(Phi, mask):
    return Phi.to(torch.float32).contiguous(), mask.to(torch.bool).contiguous()


def quality_unwrap_tiled(Phi, quality, mask, iters: int = 8, tile_h: int = 64,
                         halo: int | None = None):
    """``spatial_quality_unwrap`` through K4 (a CPU tensor: the plain
    version). ``halo``: sweeps per launch and the tiles' halo, at most
    ``MAX_HALO`` (default: min(iters, MAX_HALO)); ``ceil(iters / halo)``
    launches, each exact, so the result does not depend on it. ``tile_h``
    (the reference's row-tile height) is accepted and ignored: K4's tile
    has the kernel's own height (K4_RUN in csrc/unwrap.cu)."""
    if Phi.device.type == "cpu":
        return spatial_quality_unwrap(Phi, quality, mask, iters)
    Phi, mask = _prepare(Phi, mask)
    if iters == 0:
        return Phi.clone()
    halo = min(iters, MAX_HALO) if halo is None else halo
    for done in range(0, iters, halo):
        Phi = launch_vote_tiled(Phi, mask, min(halo, iters - done))
    return Phi


def takes_resident(H: int, W: int, layout: tuple[int, int, int, int]) -> bool:
    """``quality_unwrap``'s route on a card of K3 ``layout``
    (``resident_layout``): K3 for a map within the reference's budget whose
    tiles one wave holds, else K4."""
    wave, _, ow, oh = layout
    return not takes_tiled(H, W) and resident_tiles(H, W, ow, oh) <= wave


def quality_unwrap(Phi, quality, mask, iters: int = 8):
    """``spatial_quality_unwrap`` on the card: K3 for maps within the
    reference's budget whose tiles one wave holds, K4 for the others (a
    CPU tensor: the plain version). The recorder counts K3's launches as
    ``launches.k3``, K4's as ``launches.k4``."""
    if Phi.device.type == "cpu":
        return spatial_quality_unwrap(Phi, quality, mask, iters)
    if not takes_resident(*Phi.shape, resident_layout(Phi.device.index)):
        return quality_unwrap_tiled(Phi, quality, mask, iters=iters)
    Phi, mask = _prepare(Phi, mask)
    if iters == 0:
        return Phi.clone()
    return launch_vote_resident(Phi, mask, iters)

