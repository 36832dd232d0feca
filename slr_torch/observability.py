"""Tracing, structured logging and roofline accounting (port of
``slr/observability.py``).

- ``StageTimer``: wall-clock stage timing that waits for the card at the
  end of a stage, emitted as JSON lines;
- ``trace()``: a ``torch.profiler`` trace exported as a Chrome trace;
- ``roofline()``: bytes and flops -> the share of the H100's speed of
  light a measured time reaches;
- host-0 gating of the log for multi-process runs.

The communicated-bytes helpers of the reference belong to the multi-GPU
tier (ROADMAP slice 8) and are not here.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

# NVIDIA H100 SXM data sheet (dense rates, 700 W), not a measurement:
# HBM3 bandwidth and float32 outside the tensor cores
HBM_GBPS = 3350.0
F32_TFLOPS = 67.0


def is_host0() -> bool:
    """Rank 0 of an initialised ``torch.distributed`` job, else True."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def log_event(event: str, /, stream=None, **fields) -> None:
    """JSON-lines structured log, emitted from host 0 only."""
    if not is_host0():
        return
    rec = {"event": event, "ts": time.time(), **fields}
    (stream or sys.stderr).write(json.dumps(rec) + "\n")


def _sync(result) -> None:
    """Wait for the card on the devices of the tensors in ``result``
    (a tensor or a nested tuple/list/dict of them); CPU tensors need no
    wait."""
    if torch.is_tensor(result):
        if result.device.type == "cuda":
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _sync(v)
    elif isinstance(result, (tuple, list)):
        for v in result:
            _sync(v)


@dataclass
class StageTimer:
    """Collects per-stage wall times; ``.summary()`` feeds a benchmark."""
    times_ms: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, result_to_block=None):
        """Times the body; with ``result_to_block`` the time runs until the
        card has finished those tensors."""
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        if result_to_block is not None:
            _sync(result_to_block)
        dt = (time.perf_counter() - t0) * 1e3
        self.times_ms[name] = self.times_ms.get(name, 0.0) + dt
        log_event("stage", name=name, ms=dt)

    def summary(self) -> dict:
        return dict(self.times_ms)


def time_fn(fn, *args, iters: int = 5, warmup: int = 1, **kw) -> float:
    """Median wall ms of fn(*args), each call waited for on the card."""
    for _ in range(warmup):
        _sync(fn(*args, **kw))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args, **kw))
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return ts[len(ts) // 2]


def roofline(bytes_accessed: float, flops: float, measured_ms: float) -> dict:
    """Speed-of-light fractions for a memory- or compute-bound kernel,
    against the H100 data sheet's rates."""
    t_mem_ms = bytes_accessed / (HBM_GBPS * 1e9) * 1e3
    t_cmp_ms = flops / (F32_TFLOPS * 1e12) * 1e3
    bound = "memory" if t_mem_ms >= t_cmp_ms else "compute"
    sol_ms = max(t_mem_ms, t_cmp_ms)
    return {
        "bound": bound,
        "sol_ms": sol_ms,
        "measured_ms": measured_ms,
        "sol_fraction": sol_ms / measured_ms if measured_ms > 0 else 0.0,
        "achieved_gbps": bytes_accessed / (measured_ms * 1e-3) / 1e9,
    }


@contextlib.contextmanager
def trace(logdir: str = "slr_trace"):
    """``torch.profiler`` over the body (host, and the card when there is
    one), written as a Chrome trace ``<logdir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))
