"""Streaming scan executor (port of ``slr/pipeline/stream.py``): the copy
of the next scan's frame stack to the card overlaps the reconstruction of
the current one. A stack is an (F, H, W) scan or an (E, F, H, W) exposure
bracket, which takes ``reconstruct_scan_hdr`` (K2) in place of
``reconstruct_dense`` (K1); one stream may mix the two.

On the card each stack goes host -> card on a side CUDA stream from pinned
memory (a stack that is not pinned is first copied into pinned memory on
the host: a copy from pageable memory would be synchronous). The compute
stream waits on the copy's event, and the stack is ``record_stream``-ed on
the compute stream so the allocator does not reuse it early. At most
``prefetch`` stacks are in flight, which bounds device memory. The
parameter block of K1 (or K2) is read to the host on the compute stream at
each launch (``kernels.fused_scan.scan_params``), behind the compute stream's
wait on this stack's copy: the host waits there for the rest of that copy
and for the previous scan's work, not for the next copy, which is enqueued
after the launch. A copy enqueued a scan ahead has little left by then:
0.06 ms of a config-3 scan's ~0.5 ms on the host at prefetch 2 (one
H100; the wait spans of ``slr_torch.observability``).
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch

from slr_torch import observability as obs
from slr_torch.config import DecodeConfig, PatternConfig, ReconstructConfig
from slr_torch.device import require_device
from slr_torch.geom.camera import Camera
from slr_torch.pipeline.reconstruct import (
    ScanCloud, is_bracket, reconstruct_dense, reconstruct_scan_hdr)


def reconstruct_stream(
    frame_stacks: Iterable,
    cam: Camera,
    proj: Camera,
    cfg: PatternConfig,
    dec: DecodeConfig = DecodeConfig(),
    rec: ReconstructConfig = ReconstructConfig(),
    prefetch: int = 2,
    spatial_iters: int = 0,
    device="cuda",
) -> Iterator[ScanCloud]:
    """Reconstruct an iterable of host stacks (numpy arrays or CPU
    tensors) on ``device`` (the card unless the caller asks for the CPU),
    ``prefetch`` copies ahead.

    Yields one ``ScanCloud`` per stack, in order: of an (F, H, W) stack the
    bits of ``reconstruct_dense`` on it (with ``spatial_iters``), of an
    (E, F, H, W) exposure bracket the bits of ``reconstruct_scan_hdr`` on
    it. A bracket has no spatial repair: with ``spatial_iters`` > 0 it
    raises ``ValueError`` before it is copied. ``prefetch`` >= 1; with 1
    the next copy starts only after the current scan's launches.
    """
    if prefetch < 1:
        raise ValueError("prefetch must be >= 1")
    device = require_device(device)
    cam, proj = cam.to(device), proj.to(device)
    on_card = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_card else None
    it = iter(frame_stacks)
    buf: deque = deque()

    def pull() -> bool:
        try:
            host = next(it)
        except StopIteration:
            return False
        # the enqueue's request is the scan's that reconstructs the stack
        with obs.span("stream.enqueue") as sp:
            host = torch.from_numpy(host) if isinstance(host, np.ndarray) else host
            is_bracket(host, spatial_iters)   # refuses a bracket's repair
            if not on_card:
                buf.append((host.to(device), None, sp.request))
                return True
            if not host.is_pinned():
                host = host.pin_memory()
            with torch.cuda.stream(copy_stream):
                frames = host.to(device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(copy_stream)
            buf.append((frames, done, sp.request))
        return True

    for _ in range(prefetch):
        if not pull():
            break
    while buf:
        frames, done, rid = buf.popleft()
        if done is not None:
            compute = torch.cuda.current_stream(device)
            compute.wait_event(done)
            frames.record_stream(compute)
        with obs.request(rid):
            if is_bracket(frames):
                cloud = reconstruct_scan_hdr(frames, cam, proj, cfg, dec, rec)
            else:
                cloud = reconstruct_dense(frames, cam, proj, cfg, dec, rec,
                                          spatial_iters=spatial_iters)
        # enqueue the next copy before the caller blocks on this cloud
        pull()
        yield cloud
