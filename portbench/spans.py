"""The program's own spans, as the per-layer metrics of source
``program_span`` read them.

The program records spans on the host (``slr_torch.observability``),
stamped with ``time.time_ns()``: the clock of the profiler's events, host
and device, so they line up with a traced slice's operations. An item is a
scan (the spans of one ``scan`` root's request: the scan and the stream's
enqueue of its stack) or a fused model (the spans from one ``decode``
root's start to the next one's). Only items that ended before the traced
slice's first profiled pass count: that pass begins at the earliest
operation of ``r.trace.device``, and from there on the profiler stretches
the host's work. A program that records no spans gives no items, and its
readers return None.
"""

from __future__ import annotations

import bisect
import statistics

from portbench import tracing


def snapshot():
    """The program's recorder as it stands, or None for a program without
    one."""
    try:
        from slr_torch.observability import snapshot as take
    except ImportError:
        return None
    return take()


def _profiled_ns(r):
    if r.trace is None or not r.trace.device:
        return None
    return min(op.start for op in r.trace.device) * 1e9


def scans(r) -> list:
    """The spans of each scan that ended before the first profiled pass."""
    snap, before = snapshot(), _profiled_ns(r)
    if snap is None or before is None:
        return []
    by_request = {}
    for s in snap.spans:
        by_request.setdefault(s.request, []).append(s)
    return [spans for spans in by_request.values()
            if any(s.name == "scan" and s.parent == 0 and s.end_ns < before for s in spans)]


def models(r) -> list:
    """The spans of each fused model that ended before the first profiled
    pass (the oldest dropped when the ring has lost its start)."""
    snap, before = snapshot(), _profiled_ns(r)
    if snap is None or before is None:
        return []
    starts = sorted(s.start_ns for s in snap.spans if s.name == "decode" and s.parent == 0)
    items = [[] for _ in starts]
    for s in snap.spans:
        i = bisect.bisect_right(starts, s.start_ns) - 1
        if i >= 0:
            items[i].append(s)
    if snap.dropped:
        items = items[1:]
    return [spans for spans in items if max(s.end_ns for s in spans) < before]


def ms(spans, named=None, waits=False) -> float:
    """The summed host ms of the spans named ``named`` (a name, or a
    prefix ending in "."), or with ``waits`` of the wait spans."""
    return sum(s.end_ns - s.start_ns for s in spans if _takes(s, named, waits)) / 1e6


def syncs(spans) -> int:
    """The host syncs in the spans: their waits' counts."""
    return sum(s.syncs for s in spans)


def has(spans, named) -> bool:
    return any(s.name == named for s in spans)


def _takes(s, named, waits) -> bool:
    if waits:
        return s.wait
    return s.name.startswith(named) if named.endswith(".") else s.name == named


def median(items, value):
    """The median over the items of ``value(item)``; None without items."""
    return statistics.median(value(spans) for spans in items) if items else None


def _overlap(a, b) -> float:
    """The length of the intersection of two sorted lists of disjoint
    [start, end] intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_program_pct(r):
    """The share of the host-traced pass's idle device time (the gaps of
    ``tracing.breakdown``) during which the host was in the program's own
    work: a span open, and no wait among those open (a wait is the host
    waiting for the card)."""
    snap = snapshot()
    if snap is None or r.trace is None or not r.trace.host_device:
        return None
    iv = tracing.merged(r.trace.host_device)
    gaps = [[e0, s1] for (_, e0), (s1, _) in zip(iv, iv[1:]) if s1 > e0]
    idle = sum(e - s for s, e in gaps)
    if idle <= 0:
        return None
    lo, hi = gaps[0][0], gaps[-1][1]

    def union(spans):
        return tracing.merged(tracing.Op(s.name, s.start_ns * 1e-9, s.end_ns * 1e-9)
                              for s in spans
                              if s.end_ns * 1e-9 > lo and s.start_ns * 1e-9 < hi)

    program = union(s for s in snap.spans if s.parent == 0)
    waits = union(s for s in snap.spans if s.wait)
    return (_overlap(gaps, program) - _overlap(gaps, waits)) / idle * 100.0
