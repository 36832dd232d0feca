"""The metric arithmetic on synthetic timestamps and a synthetic trace."""

import types

import pytest

from portbench import harness, stats, tracing
from portbench.frozen import arith


def test_rate_over_whole_window():
    # 10 scans, the window from its start to the end of the last scan
    assert stats.rate_per_s(10, 100.0, 102.5) == pytest.approx(4.0)


def test_p95_over_all_scans():
    lat = [1.0] * 95 + [10.0] * 5          # one stall in twenty
    assert stats.p95(lat) == pytest.approx(1.45)
    assert stats.p95(list(range(1, 102))) == pytest.approx(96.0)


def test_model_ms_extends_to_last_model():
    # 3 models; the last ends 0.4 s past a 5 s window
    assert stats.ms_per_item(3, 10.0, 15.4) == pytest.approx(1800.0)


def _trace(device, wall, items=2, host=(), unprofiled=None):
    ops = [tracing.Op(n, s, e) for n, s, e in device]
    return tracing.Trace(device=ops, wall_s=wall, items=items,
                         host=[tracing.Op(n, s, e) for n, s, e in host],
                         host_device=ops, wall_unprofiled_s=unprofiled or wall)


def test_idle_is_a_union_of_intervals():
    # two copies overlap a kernel: busy 0-3 and 5-6, not the sum 1+3+1+1
    tr = _trace([("k", 0.0, 1.0), ("Memcpy HtoD", 0.5, 3.0), ("m", 2.0, 3.0),
                 ("k", 5.0, 6.0)], wall=10.0)
    assert tracing.busy_s(tr.device) == pytest.approx(4.0)
    assert tracing.idle_share(tr) == pytest.approx(0.6)
    assert tracing.idle_share(_trace([], wall=1.0)) is None


def test_idle_is_over_the_unprofiled_wall():
    # the profiler stretched the traced wall from 2.5 s to 4 s
    tr = _trace([("k", 0.0, 2.0)], wall=4.0, unprofiled=2.5)
    assert tracing.idle_share(tr) == pytest.approx(0.2)


def test_busy_over_the_wall_is_a_fault():
    with pytest.raises(ValueError):
        tracing.idle_share(_trace([("k", 0.0, 2.0)], wall=2.5, unprofiled=1.5))


def test_breakdown_names_gaps_by_host():
    tr = _trace([("k1", 0.0, 1.0), ("k2", 3.0, 4.0), ("k1", 4.5, 5.0)], wall=5.0,
                host=[("portbench.register", 0.0, 5.0), ("aten::item", 1.5, 2.9)])
    b = tracing.breakdown(tr)
    assert b["device_ops"][0] == ["k1", pytest.approx(1.5)]
    assert b["idle_gaps"][0] == ["portbench.register / aten::item", pytest.approx(2.0)]
    assert b["idle_gaps"][1] == ["portbench.register", pytest.approx(0.5)]


def test_k1_bytes_at_config3_uint8():
    # chip_smoke.py's 62.9 MB: (20 frames x 1 B + 7 x 4 B) a pixel
    assert arith.k1_bytes(1024, 1280, 20, 1) == 62_914_560
    assert arith.bound_s(62_914_560) * 1e3 == pytest.approx(0.018780, abs=1e-6)


def test_vote_bound_is_operations():
    # 30 instructions a pixel and sweep, 8 sweeps: 0.0094 ms on config 3
    least = arith.bound_s(arith.vote_bytes(1024, 1280), arith.vote_instr(1024, 1280, 8))
    assert least * 1e3 == pytest.approx(0.00939, abs=1e-5)


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py")


def test_readers_on_a_synthetic_trace():
    cfg = harness.load_cell("scan_stream_repair")[1]
    ops = [("Memcpy HtoD (Pinned -> Device)", 0.0, 0.001),
           ("void fused_scan_kernel<unsigned char>(...)", 0.001, 0.00104),
           ("vote_tiled_kernel(...)", 0.0011, 0.00115)] * 2
    r = harness.ReaderInput(_trace(ops, wall=0.004, items=2), {}, cfg,
                            {"spatial_iters": 8})
    assert _reader("h2d_ms_per_scan").read(r) == pytest.approx(1.0)
    assert _reader("device_ops_per_scan").read(r) == 3
    assert _reader("k1_roofline_pct").read(r) == pytest.approx(0.01878 / 0.04 * 100, rel=1e-3)
    assert _reader("vote_roofline_pct").read(r) == pytest.approx(0.00939 / 0.05 * 100, rel=1e-3)
    idle = 100 * (1 - 0.00109 / 0.004)          # the repeats overlap
    assert _reader("device_idle_pct.scan").read(r) == pytest.approx(idle)
    assert _reader("device_idle_pct.fusion").read(r) == pytest.approx(idle)
    # nothing to read: no value, never a 0
    empty = harness.ReaderInput(_trace([], wall=1.0), {}, cfg, {"spatial_iters": 0})
    for name in ("h2d_ms_per_scan", "k1_roofline_pct", "vote_roofline_pct",
                 "device_idle_pct.scan", "device_ops_per_scan"):
        assert _reader(name).read(empty) is None


def test_span_readers():
    r = harness.ReaderInput(None, {"register": [0.5, 0.7], "decode": [0.01]}, {}, {})
    assert _reader("register_ms").read(r) == pytest.approx(600.0)
    assert _reader("decode_ms_per_model").read(r) == pytest.approx(10.0)
    assert _reader("ba_ms").read(r) is None


def test_limits_check():
    got = harness.limits_check({"a": 0.1, "faces_min": 10, "b": 2.0},
                               {"a": 0.2, "faces_min": 5, "b": None})
    assert [g[3] for g in got] == [True, True, False]
    assert harness.limits_check({"a": 0.3}, {"a": 0.2})[0][3] is False


def test_reports_follows_workloads_or_moves():
    bench = {"end_to_end": [{"name": "x", "workloads": ["c1"]}, {"name": "setup_s"}]}
    assert harness.reports({"name": "m", "workloads": ["c2"]}, "c2", bench)
    assert harness.reports({"name": "m", "moves": "x"}, "c1", bench)
    assert not harness.reports({"name": "m", "moves": "x"}, "c2", bench)
    assert harness.reports({"name": "m", "moves": "setup_s"}, "c9", bench)


def test_k7_bytes_at_the_merge():
    # chip_smoke.py's bounds reading every input: 0.0145 / 0.0113 ms
    assert arith.bound_s(arith.k7_bytes(1024, 1280, 1024)) * 1e3 == pytest.approx(0.014477, abs=1e-6)
    assert arith.bound_s(arith.k7_bytes(1024, 1024, 768)) * 1e3 == pytest.approx(0.011268, abs=1e-6)


def test_twocam_readers_on_a_synthetic_trace():
    # the merge's K1 launches are all the decode-only build: k1_roofline_pct
    # reads them at the configuration's 36 frames
    cfg = harness.load_cell("merge_twocam_u8")[1]
    k1 = "void (anonymous namespace)::fused_scan_kernel<unsigned char, 2, false>(...)"
    ops = [("Memcpy HtoD (Pinned -> Device)", 0.0, 0.002),
           (k1, 0.002, 0.00205), (k1, 0.0021, 0.00215)]
    ops += [("void (anonymous namespace)::interp_fused_kernel<4, 3>(...)",
             0.003 + 0.001 * i, 0.00305 + 0.001 * i) for i in range(4)]
    r = harness.ReaderInput(_trace(ops, wall=0.01, items=1), {}, cfg, {"pool": 8})
    least_k1 = (36 + 28) * 1280 * 1024 / arith.HBM_BYTES_PER_S
    assert _reader("k1_roofline_pct").read(r) == pytest.approx(least_k1 / 5e-5 * 100)
    least_k7 = 2 * (arith.k7_bytes(1024, 1280, 1024) + arith.k7_bytes(1024, 1024, 768))
    assert _reader("k7_roofline_pct").read(r) == pytest.approx(
        least_k7 / arith.HBM_BYTES_PER_S / 2e-4 * 100)
    assert _reader("device_ops_per_scan").read(r) == 7
    assert _reader("h2d_ms_per_scan").read(r) == pytest.approx(2.0)
    # neither kernel in the trace, or no trace: no value, never a 0
    other = harness.ReaderInput(_trace(ops[:1], wall=0.01, items=1), {}, cfg, {})
    for name in ("k1_roofline_pct", "k7_roofline_pct"):
        assert _reader(name).read(other) is None
        assert _reader(name).read(harness.ReaderInput(None, {}, cfg, {})) is None
