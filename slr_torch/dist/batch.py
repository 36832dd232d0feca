"""Batched reconstruction of many scans (port of ``slr/dist/batch.py``).

The reference maps the single-scan pipeline over the batch with
``jax.vmap``. A kernel launched through ctypes cannot be vmapped, so the
port reconstructs one scan at a time (one K1 launch a scan) and stacks the
clouds: every scan's bits are those of the single-scan call. Sharding the
batch over GPUs (``mesh=``) comes with the multi-GPU tier (ROADMAP
slice 8).
"""

from __future__ import annotations

import torch

from slr_torch.config import DecodeConfig, PatternConfig, ReconstructConfig
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
    leading batch dim (B, ...). ``mesh`` other than None raises
    ``NotImplementedError`` (multi-GPU, slice 8)."""
    if mesh is not None:
        raise NotImplementedError("batched_reconstruct: mesh= (the batch sharded over "
                                  "map_block) comes with multi-GPU, ROADMAP slice 8; "
                                  "pass mesh=None")
    f = reconstruct_dense if fused else reconstruct_scan
    clouds = [f(frames, cam, proj, cfg, dec, rec) for frames in frames_batch]
    return ScanCloud(*(torch.stack(x) for x in zip(*clouds)))
