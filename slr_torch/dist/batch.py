"""Batched reconstruction of many scans (port of ``slr/dist/batch.py``).

The reference maps the single-scan pipeline over the batch with
``jax.vmap``. A kernel launched through ctypes cannot be vmapped, so the
port reconstructs one scan at a time (one K1 launch a scan) and stacks the
clouds: every scan's bits are those of the single-scan call. With a mesh
the batch is split over ``map_block`` (scan-level data parallel, no
communication but the final gather).
"""

from __future__ import annotations

import torch

from slr_torch import observability as obs
from slr_torch.config import DecodeConfig, PatternConfig, ReconstructConfig
from slr_torch.dist import comm
from slr_torch.pipeline.reconstruct import ScanCloud, reconstruct_dense, reconstruct_scan


def batched_reconstruct(
    frames_batch,             # (B, F, H, W), or a sequence of B (F, H, W) stacks
    cam,
    proj,
    cfg: PatternConfig,
    dec: DecodeConfig = DecodeConfig(),
    rec: ReconstructConfig = ReconstructConfig(),
    mesh=None,
    fused: bool = True,
) -> ScanCloud:
    """Reconstruct every scan of the batch (``reconstruct_dense``, or
    ``reconstruct_scan`` when ``fused`` is off). Returns a ScanCloud with a
    leading batch dim (B, ...). With a ``mesh`` every rank passes the whole
    batch (B divisible by the map blocks), reconstructs its block of scans
    and gets the whole batch back, gathered in block order."""
    f = reconstruct_dense if fused else reconstruct_scan
    scans = range(len(frames_batch))
    if mesh is not None:
        nb, b = mesh.shape["map_block"], mesh.coords["map_block"]
        if len(scans) % nb:
            raise ValueError(f"a batch of {len(scans)} scans does not split over "
                             f"{nb} map blocks")
        per = len(scans) // nb
        scans = scans[b * per:(b + 1) * per]
    with obs.span("decode"):
        clouds = [f(frames_batch[i], cam, proj, cfg, dec, rec) for i in scans]
        out = [torch.stack(x) for x in zip(*clouds)]
        if mesh is not None:
            out = comm.all_gather_rows(out, mesh.groups["map_block"])
    return ScanCloud(*out)
