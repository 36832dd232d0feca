"""The traced slice of a run: a bounded, steady piece of work run three
times, once unprofiled (its wall), once under ``torch.profiler`` with CUDA
activity alone (the device's operations, which the per-layer metrics
read), and once with host activity too (what the host was doing in each
idle gap, for the breakdown alone). The idle share is the device-traced
pass's busy time over the unprofiled pass's wall: the profiler's cost on
the host, even with CUDA activity alone, stretches a traced wall. And the
arithmetic they share: the union of device intervals (overlaps counted
once) and the idle gaps between them.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import NamedTuple

import torch

SPAN_PREFIX = "portbench."


class Op(NamedTuple):
    name: str
    start: float   # seconds on the profiler's clock
    end: float


class Trace(NamedTuple):
    device: list    # Op of every kernel, copy and memset on the card
    wall_s: float   # host wall of the slice, ending in a card sync
    items: int      # scans or models the slice completed
    host: list      # the host-traced pass: Op of every host event (spans among them)
    host_device: list   # the host-traced pass's device Ops
    wall_unprofiled_s: float    # the slice's wall with no profiler on


def _ns(ev, which: str) -> float:
    if hasattr(ev, f"{which}_ns"):
        return getattr(ev, f"{which}_ns")()
    return getattr(ev, f"{which}_us")() * 1e3


def _run(fn, activities):
    """(device ops, host ops, wall, items) of ``fn()`` under the profiler
    with ``activities`` (none: no profiler)."""
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    if not activities:
        t0 = time.perf_counter()
        items = fn()
        torch.cuda.synchronize()
        return [], [], time.perf_counter() - t0, items
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        items = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start") * 1e-9
        op = Op(ev.name(), start, start + ev.duration_ns() * 1e-9)
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            host.append(op)
        elif not op.name.startswith(SPAN_PREFIX):
            # the profiler mirrors each span onto the card's timeline as an
            # annotation: not an operation of the card
            device.append(op)
    return device, host, wall, items


def profile(fn) -> Trace:
    """Run ``fn()`` (which returns the items it completed, its card work
    waited on) unprofiled, under the profiler with CUDA activity, and with
    host and CUDA activity."""
    from torch.profiler import ProfilerActivity

    _, _, wall_free, _ = _run(fn, [])
    device, _, wall, items = _run(fn, [ProfilerActivity.CUDA])
    host_device, host, _, _ = _run(fn, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    return Trace(device=device, wall_s=wall, items=items, host=host,
                 host_device=host_device, wall_unprofiled_s=wall_free)


def merged(ops) -> list:
    """The union of the ops' intervals as sorted, disjoint (start, end)."""
    out = []
    for s, e in sorted((op.start, op.end) for op in ops):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(ops) -> float:
    """Seconds in which at least one op ran (overlaps counted once)."""
    return sum(e - s for s, e in merged(ops))


def idle_share(trace: Trace) -> float | None:
    """The share of the unprofiled slice's wall in which no device op ran;
    a busy time above that wall is a fault of the measurement, and raises."""
    if not trace.device or trace.wall_unprofiled_s <= 0:
        return None
    busy = busy_s(trace.device)
    if busy > trace.wall_unprofiled_s:
        raise ValueError(f"device busy {busy!r} s over an unprofiled wall of "
                         f"{trace.wall_unprofiled_s!r} s")
    return 1.0 - busy / trace.wall_unprofiled_s


def _outermost(ops) -> list:
    """The ops that no earlier op covers, sorted by start."""
    out = []
    for op in sorted(ops, key=lambda op: (op.start, -op.end)):
        if not out or op.start >= out[-1].end:
            out.append(op)
    return out


def _covering(tops, starts, t: float):
    i = bisect.bisect_right(starts, t) - 1
    return tops[i] if i >= 0 and tops[i].end >= t else None


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device ops that took the most time (summed by name) and the idle
    gaps between device work summed by what the host was doing at each
    gap's middle: the innermost benchmark span and the outermost program
    operation then running (from the host-traced pass, whose gaps the
    host's tracing lengthens); each list the ``top`` largest, in seconds."""
    by_op = defaultdict(float)
    for op in trace.device:
        by_op[op.name[:160]] += op.end - op.start
    spans = [op for op in trace.host if op.name.startswith(SPAN_PREFIX)]
    tops = _outermost(op for op in trace.host if not op.name.startswith(SPAN_PREFIX))
    starts = [op.start for op in tops]
    iv = merged(trace.host_device)
    gaps = defaultdict(float)
    for (_, e0), (s1, _) in zip(iv, iv[1:]):
        t = 0.5 * (e0 + s1)
        inside = [op for op in spans if op.start <= t <= op.end]
        label = min(inside, key=lambda op: op.end - op.start).name if inside else "(no span)"
        op = _covering(tops, starts, t)
        gaps[(label + " / " + op.name if op else label)[:160]] += s1 - e0
    return {"device_ops": sorted(([k, v] for k, v in by_op.items()), key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:top]}
