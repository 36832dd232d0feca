"""Tracing, structured logging and roofline accounting (port of
``slr/observability.py``).

- the recorder: ``span(name)`` and ``wait(name)`` (a span around a call
  that makes the host wait for the card; ``upload`` copies in one),
  ``count(name, n)`` for host-side
  running totals, ``snapshot()`` to read them, ``recording(on)`` to switch
  them off. Spans are stamped with ``time.time_ns()``, the clock of the
  profiler's events (host and, through CUPTI's converter, device), so an
  idle gap of a device trace can be put down to the span then open. A span
  neither waits for the card nor launches anything, and never enters the
  profiler's timeline. The ring keeps the newest spans; nesting, the ring
  and the counters are kept for the process without a lock (the port
  records from one thread);
- ``trace()``: a ``torch.profiler`` trace exported as a Chrome trace, the
  recorder's spans of the traced body beside the profiler's events;
- ``roofline()``: bytes and flops -> the share of the H100's speed of
  light a measured time reaches;
- host-0 gating of the log for multi-process runs;
- the communicated-bytes helpers of the parallel tier (``slr_torch.dist``).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch

# NVIDIA H100 SXM data sheet (dense rates, 700 W), not a measurement:
# HBM3 bandwidth and float32 outside the tensor cores
HBM_GBPS = 3350.0
F32_TFLOPS = 67.0


# ---- the recorder -----------------------------------------------------------

# spans the ring holds: the newest RING of them
RING = 1 << 17


class SpanRecord(NamedTuple):
    name: str
    start_ns: int     # time.time_ns(), the profiler's clock
    end_ns: int
    id: int           # > 0, in the order the spans opened
    parent: int       # the enclosing span's id; 0 for a root
    request: int      # the id of the root, shared by every span under it
    syncs: int        # the host syncs in it: a wait's (one a call, but a call
                      # that syncs more); 0 for every other span

    @property
    def wait(self) -> bool:
        return self.syncs > 0


class Snapshot(NamedTuple):
    spans: list       # SpanRecord, in the order they closed, the newest RING
    counts: dict      # counter name -> running total
    dropped: int      # spans closed before the ring's oldest


_on = True
_ring: collections.deque = collections.deque(maxlen=RING)
_dropped = 0
_ids = itertools.count(1)
_counts: dict = {}
_now = time.time_ns
# the open spans, innermost last, and the request the next root span joins
# (0: its own). One nesting for the process: the port records from one thread.
_stack: list = []
_request = 0


class span:
    """``with span(name) as s:`` records the body's host interval, its
    parent (the innermost span open) and its request: a root span's own
    id, or the one ``request`` hands it; ``s.request`` reads it."""
    __slots__ = ("name", "syncs", "id", "parent", "request", "start", "end")

    def __init__(self, name: str):
        self.name, self.syncs, self.id, self.request = name, 0, 0, 0

    def __enter__(self):
        if _on:
            stack = _stack
            self.id = i = next(_ids)
            if stack:
                top = stack[-1]
                self.parent, self.request = top.id, top.request
            else:
                self.parent, self.request = 0, _request or i
            stack.append(self)
            self.start = _now()
        return self

    def __exit__(self, *exc):
        global _dropped
        if self.id:
            self.end = _now()
            stack = _stack
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:
                stack.remove(self)
            if len(_ring) == RING:
                _dropped += 1
            _ring.append(self)
        return False


class wait(span):
    """A span around one call that makes the host wait for the card when
    its tensors are on the card (a read to the host, a count, a boolean
    mask, a copy from pageable memory). ``syncs``: the syncs of that call,
    1 but for a call that syncs more (``torch.linalg.svd`` on the card: 2);
    0 makes it a plain span. The waits' syncs are the host syncs. A CPU run
    marks the same calls with the syncs they make on the card, so the CPU
    tests hold the count."""
    __slots__ = ()

    def __init__(self, name: str, syncs: int = 1):
        self.name, self.syncs, self.id, self.request = name, syncs, 0, 0


class request:
    """``with request(rid):`` the root spans opened in the body join
    request ``rid`` (0: each its own): a stream hands the id of a stack's
    enqueue to that scan."""
    __slots__ = ("rid", "before")

    def __init__(self, rid: int):
        self.rid = rid

    def __enter__(self):
        global _request
        self.before, _request = _request, self.rid

    def __exit__(self, *exc):
        global _request
        _request = self.before
        return False


def upload(name: str, x, device=None, dtype=None):
    """``torch.as_tensor(x, dtype=dtype, device=device)`` in a ``wait``: a
    copy from the host's pageable memory, which the host waits for, or a
    read of a card tensor to the CPU. A card tensor that stays on the card
    is copied nowhere: a plain span."""
    on_card = torch.is_tensor(x) and x.device.type != "cpu"
    to_card = on_card if device is None else torch.device(device).type != "cpu"
    with wait(name, syncs=0 if on_card and to_card else 1):
        return torch.as_tensor(x, dtype=dtype, device=device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host-side running total ``name``."""
    if _on:
        _counts[name] = _counts.get(name, 0) + n


def recording(on: bool) -> bool:
    """Switch the recorder (spans and counts) on or off; returns the state
    it was in."""
    global _on
    before, _on = _on, bool(on)
    return before


def snapshot() -> Snapshot:
    """What the recorder holds now (a copy)."""
    held, dropped = list(_ring), _dropped
    return Snapshot(
        spans=[SpanRecord(s.name, s.start, s.end, s.id, s.parent, s.request, s.syncs)
               for s in held],
        counts=dict(_counts), dropped=dropped)


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
    one), written as a Chrome trace ``<logdir>/trace.json``; the recorder's
    spans closed in the body join it on the profiler's clock, as the
    complete events of one track (``tid`` "slr_torch spans")."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    first = next(_ids)
    with profile(activities=acts) as prof:
        yield logdir
    path = Path(logdir) / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    base = data.get("baseTimeNanoseconds", 0)
    data["traceEvents"].extend(
        {"ph": "X", "cat": "slr_span", "name": s.name, "pid": os.getpid(),
         "tid": "slr_torch spans", "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "parent": s.parent, "request": s.request, "syncs": s.syncs}}
        for s in snapshot().spans if s.id > first)
    path.write_text(json.dumps(data))


# ---- communicated-bytes accounting ----------------------------------------
#
# Every collective of the parallel tier moves a volume known from the
# shapes.


def comm_halo_bytes(width: int, halo: int, dtype_bytes: int = 4,
                    n_arrays: int = 1, iters: int = 1) -> int:
    """Bytes a rank sends per sharded-unwrap call: two ring sends (up and
    down) of ``halo`` rows per array per exchange (``slr_torch/dist/halo.py``,
    ``sharded.py``)."""
    return 2 * halo * width * dtype_bytes * n_arrays * iters


def comm_schur_bytes(n_poses: int, iters: int = 1) -> int:
    """Bytes a rank moves per distributed-BA solve: the reduced (6S x 6S)
    pose system, its right-hand side and 2 scalars, one float32 buffer
    all-reduced per Gauss-Newton iteration (``slr_torch/dist/ba.py``); an
    all-reduce over N ranks moves ~2x the payload a rank (reduce-scatter
    and all-gather)."""
    s = 6 * n_poses
    return (s * s + s + 2) * 4 * 2 * iters


def comm_batched_icp_bytes(n_edges_local: int, iters: int = 1) -> int:
    """A registration round sharded over map_block communicates nothing per
    edge (edges are block-local); only the round's pose table is gathered:
    12 floats per edge."""
    return n_edges_local * 12 * 4 * iters
