"""The readers of the program's own spans (source ``program_span``) on a
synthetic snapshot of the recorder and a synthetic trace: items grouped by
request or by model, only those before the first profiled pass, medians;
nothing to read gives no value."""

import pytest

from portbench import harness, spans, tracing
from slr_torch.observability import Snapshot, SpanRecord

MS = 1_000_000        # ns


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py")


class _Recorder:
    """Spans written as a program would close them, with ids in the order
    they open."""

    def __init__(self):
        self.records, self.next = [], 1

    def span(self, name, start, end, parent=None, syncs=0):
        sid, self.next = self.next, self.next + 1
        request = parent.request if parent else sid
        rec = SpanRecord(name, start, end, sid, parent.id if parent else 0, request, syncs)
        self.records.append(rec)
        return rec

    def snapshot(self, dropped=0):
        return Snapshot(spans=sorted(self.records, key=lambda s: s.end_ns),
                        counts={}, dropped=dropped)


def _trace(device, host_device=None):
    ops = [tracing.Op(n, s, e) for n, s, e in device]
    hd = ops if host_device is None else [tracing.Op(n, s, e) for n, s, e in host_device]
    return tracing.Trace(device=ops, wall_s=1.0, items=1, host=[], host_device=hd,
                         wall_unprofiled_s=1.0)


def _scan(rec, t0, wait_ms, repair_ms=0.0, vote_ms=0.0):
    """One streamed scan at ``t0`` ms: the enqueue, then the scan root
    (request: the enqueue's) with K1's parameter read and launch, and the
    repair."""
    enq = rec.span("stream.enqueue", t0 * MS, (t0 + 0.1) * MS)
    a = t0 + 0.2
    end = a + 0.1 + wait_ms + 0.05 + repair_ms
    root = SpanRecord("scan", int(a * MS), int(end * MS), rec.next, 0, enq.request, 0)
    rec.next += 1
    rec.records.append(root)
    params = rec.span("k1.params", int((a + 0.05) * MS), int((a + 0.1 + wait_ms) * MS), root)
    rec.span("params.read", int((a + 0.1) * MS), int((a + 0.1 + wait_ms) * MS), params,
             syncs=1)
    b = a + 0.1 + wait_ms
    rec.span("k1.launch", int(b * MS), int((b + 0.05) * MS), root)
    if repair_ms:
        rep = rec.span("repair", int((b + 0.05) * MS), int((b + 0.05 + repair_ms) * MS), root)
        rec.span("repair.vote", int((b + 0.1) * MS), int((b + 0.1 + vote_ms) * MS), rep)
    return end


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(spans, "snapshot", lambda: rec.snapshot())
    return rec


def test_scan_readers(recorder):
    ends = [_scan(recorder, 10.0 * i, wait_ms=w, repair_ms=r, vote_ms=0.5)
            for i, (w, r) in enumerate([(0.4, 3.0), (0.5, 5.0), (0.45, 4.0)])]
    # a scan inside the profiled pass does not count
    _scan(recorder, 100.0, wait_ms=9.0, repair_ms=90.0, vote_ms=0.5)
    r = harness.ReaderInput(_trace([("k", 0.099, 0.1)]), {}, {}, {})
    assert max(ends) * MS < 0.099e9
    assert _reader("host_syncs_per_scan").read(r) == 1
    assert _reader("host_wait_ms_per_scan").read(r) == pytest.approx(0.45)
    # the scan root: 0.1 + wait + 0.05 + repair
    assert _reader("scan_host_ms").read(r) == pytest.approx(0.15 + 0.45 + 4.0)
    assert _reader("repair_glue_ms").read(r) == pytest.approx(4.0 - 0.5)
    # every scan inside the profiled pass: nothing to read
    early = harness.ReaderInput(_trace([("k", 0.001, 0.002)]), {}, {}, {})
    for name in ("scan_host_ms", "host_wait_ms_per_scan", "host_syncs_per_scan",
                 "repair_glue_ms"):
        assert _reader(name).read(early) is None


def _model(rec, t0, text_ms, waits):
    """One fused model at ``t0`` ms: decode (a scan with its read),
    register (ICP, its polish, the race, the pose graph), the TSDF's bounds
    read and the writer, whose extraction reads its count."""
    dec = rec.span("decode", t0 * MS, (t0 + 5) * MS)
    scan = rec.span("scan", (t0 + 1) * MS, (t0 + 2) * MS, dec)
    rec.span("params.read", (t0 + 1) * MS, int((t0 + 1.5) * MS), scan, syncs=1)
    reg = rec.span("register", (t0 + 10) * MS, (t0 + 100) * MS)
    rec.span("icp", (t0 + 11) * MS, (t0 + 21) * MS, reg)
    rec.span("icp.polish", (t0 + 21) * MS, (t0 + 24) * MS, reg)
    rec.span("features.fpfh", (t0 + 30) * MS, (t0 + 37) * MS, reg)
    fit = rec.span("features.fit", (t0 + 40) * MS, (t0 + 42) * MS, reg)
    rec.span("kabsch.svd", (t0 + 41) * MS, int((t0 + 41.5) * MS), fit, syncs=2)
    rec.span("icp", (t0 + 50) * MS, (t0 + 60) * MS, reg)
    pg = rec.span("pose_graph", (t0 + 80) * MS, (t0 + 95) * MS, reg)
    for i in range(waits):
        rec.span("register.upload", (t0 + 80 + i) * MS, int((t0 + 80.5 + i) * MS), pg,
                 syncs=1)
    mw = rec.span("mesh_write", (t0 + 200) * MS, (t0 + 200 + 50 + text_ms) * MS)
    ext = rec.span("mesh.extract", (t0 + 200) * MS, (t0 + 230) * MS, mw)
    rec.span("mesh.count", (t0 + 201) * MS, (t0 + 203) * MS, ext, syncs=1)
    rec.span("mesh.read", (t0 + 230) * MS, (t0 + 240) * MS, mw, syncs=1)
    rec.span("mesh.text", (t0 + 240) * MS, (t0 + 240 + text_ms) * MS, mw)
    return (t0 + 250 + text_ms) * MS


def test_fusion_readers(recorder):
    for i, (text, waits) in enumerate([(700, 2), (900, 2), (800, 4)]):
        _model(recorder, 2000 * i, text, waits)
    _model(recorder, 10_000, 5000, 9)            # a profiled model
    r = harness.ReaderInput(_trace([("k", 9.999, 10.0)]), {}, {}, {})
    assert _reader("obj_text_ms").read(r) == pytest.approx(800.0)
    assert _reader("mesh_extract_ms").read(r) == pytest.approx(30.0 + 10.0)
    assert _reader("icp_ms_per_model").read(r) == pytest.approx(10.0 + 3.0 + 10.0)
    assert _reader("features_ms_per_model").read(r) == pytest.approx(7.0 + 2.0)
    assert _reader("pose_graph_ms").read(r) == pytest.approx(15.0)
    # waits: the decode's read, the SVD (two syncs in one call), the pose
    # graph's uploads, the count and the read
    assert _reader("host_syncs_per_model").read(r) == 1 + 2 + 2 + 2
    assert _reader("host_wait_ms_per_model").read(r) == pytest.approx(
        0.5 + 0.5 + 2 * 0.5 + 2 + 10)
    # a ring that lost its oldest spans drops the oldest model
    recorder.snapshot = lambda: _Recorder.snapshot(recorder, dropped=1)
    assert _reader("host_syncs_per_model").read(r) == pytest.approx((2 + 4) / 2 + 5)


def test_idle_in_program():
    """Gaps of the host-traced pass: 1-3 s and 4-8 s (6 s idle). The program
    has a root over 0-5 s with a wait over 2-2.5 s, and another over 7-9 s:
    its own work covers 1-2, 2.5-3, 4-5 and 7-8 s: 3.5 s."""
    rec = _Recorder()
    root = rec.span("register", 0, 5_000 * MS)
    rec.span("register.accept", 2_000 * MS, 2_500 * MS, root, syncs=1)
    rec.span("tsdf", 7_000 * MS, 9_000 * MS)
    dev = [("k", 0.0, 1.0), ("k", 3.0, 4.0), ("k", 8.0, 9.0)]
    r = harness.ReaderInput(_trace([("k", 0.0, 1.0)], host_device=dev), {}, {}, {})
    orig = spans.snapshot
    try:
        spans.snapshot = rec.snapshot
        assert _reader("idle_in_program_pct.scan").read(r) == pytest.approx(3.5 / 6 * 100)
        assert _reader("idle_in_program_pct.fusion").read(r) == pytest.approx(3.5 / 6 * 100)
    finally:
        spans.snapshot = orig


NEW = ("scan_host_ms", "host_wait_ms_per_scan", "host_syncs_per_scan", "repair_glue_ms",
       "idle_in_program_pct.scan", "mesh_extract_ms", "obj_text_ms", "icp_ms_per_model",
       "features_ms_per_model", "pose_graph_ms", "host_wait_ms_per_model",
       "host_syncs_per_model", "idle_in_program_pct.fusion")


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_no_value(name, monkeypatch):
    """No trace, or a program that records no spans (an older one): None,
    never a 0 and never an error."""
    tr = harness.ReaderInput(_trace([("k", 1.0, 2.0)]), {}, {}, {})
    assert _reader(name).read(harness.ReaderInput(None, {}, {}, {})) is None
    monkeypatch.setattr(spans, "snapshot", lambda: None)
    assert _reader(name).read(tr) is None


def test_a_program_without_the_recorder(monkeypatch):
    """``snapshot`` finds no recorder in a program that has none."""
    import slr_torch.observability as ob

    monkeypatch.delattr(ob, "snapshot")
    assert spans.snapshot() is None
    assert spans.scans(harness.ReaderInput(_trace([("k", 1.0, 2.0)]), {}, {}, {})) == []


def test_every_new_metric_is_in_the_manifest():
    bench = harness.manifest()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["source"] == "program_span" and m["workloads"], name
