"""The 5 MP two-camera cell ``merge_twocam_5mp``: its files found by name,
its two readers on synthetic traces and spans, and a run of the cell on CPU
tensors at a small size with the route rule forced to the tiled route, the
route the cell's 2448x2048 pair takes on the card.

As in ``test_portbench_twocam.py``, the program decodes there by K1's plain
version with the card's rounding, the arithmetic the card runs.
"""

import time

import pytest
import torch

from portbench import harness, spans, tracing
from portbench.frozen import arith
from slr_torch.kernels import fused_scan as fs
from slr_torch.observability import Snapshot, SpanRecord
from slr_torch.pipeline import twocam as tw
from test_portbench_twocam import _k1_decode, _unwrap_rounded_once

CELL = "merge_twocam_5mp"
MS = 1_000_000        # ns
_, CFG, _, _ = harness.load_cell(CELL)
SMALL = {"camera": {**CFG["camera"], "width": 256, "height": 192},
         "projector": {"width": 256, "height": 192},
         "pattern": {"coding": "gray_phase", "gray_bits": 5, "row_gray_bits": 5,
                     "use_inverse": True, "phase_steps": 3, "row_phase_steps": 3, "frames": 28},
         "checks": {**CFG["checks"], "limits": {**CFG["checks"]["limits"],
                                                "valid_cells_min": 256 * 192 // 2}}}
SMALL_MIX = {"pool": 2, "profile_scans": 2}


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py")


def _trace(device, items=1):
    ops = [tracing.Op(n, s, e) for n, s, e in device]
    return tracing.Trace(device=ops, wall_s=1.0, items=items, host=[], host_device=ops,
                         wall_unprofiled_s=1.0)


def test_the_cell_finds_its_files():
    cell, cfg, mix, gen = harness.load_cell(CELL)
    assert (cell["config"], cell["chips"]) == ("twocam_2448x2048", 1)
    assert cfg["reduced"] == [] and cfg["name"] == "twocam_2448x2048"
    assert (cfg["camera"]["width"], cfg["camera"]["height"]) == (2448, 2048)
    assert mix == {"kind": "twocam_stream", "params": {"pool": 8, "profile_scans": 100}}
    assert gen.__name__ == "portbench_twocam_stream"
    # everything but the sensor is the 1.3 MP cell's configuration
    _, small, _, _ = harness.load_cell("merge_twocam_u8")
    for key in ("projector", "pattern", "frame_dtype", "scene", "decode", "reconstruct",
                "method", "assumed"):
        assert cfg[key] == small[key], key
    assert cfg["checks"]["tolerances"] == small["checks"]["tolerances"]
    assert {k: v for k, v in cfg["camera"].items() if k not in ("width", "height")} == \
        {k: v for k, v in small["camera"].items() if k not in ("width", "height")}
    # the reference's route rule sends this sensor to the tiled route
    pr = cfg["projector"]
    assert not tw.takes_fused(2048, 2448, pr["width"], pr["height"])
    assert tw.takes_fused(1024, 1280, pr["width"], pr["height"])


@pytest.mark.parametrize("kernel", [
    "void (anonymous namespace)::bin_sum_kernel<false>(...)",
    "void (anonymous namespace)::interp_fused_kernel<4, 3>(...)"])
def test_crossing_roofline_reads_either_route(kernel):
    """The same least time over K6's launches or K7's: the passes' own
    work, whichever kernel does it; the route's other launches are not the
    crossing kernels' time."""
    glue = [("void at::native::vectorized_elementwise_kernel<4>(...)", 0.0, 0.001)]
    ops = glue + [(kernel, 0.001 + 0.001 * i, 0.00105 + 0.001 * i) for i in range(8)]
    r = harness.ReaderInput(_trace(ops, items=2), {}, CFG, {})
    least = 2 * (arith.k7_bytes(2048, 2448, 1024) + arith.k7_bytes(1024, 2048, 768))
    assert least == 413_990_912
    # 8 launches of 0.05 ms over 2 scans: 0.2 ms a scan
    got = _reader("crossing_roofline_pct").read(r)
    assert got == pytest.approx(least / arith.HBM_BYTES_PER_S / 2e-4 * 100)
    assert got == pytest.approx(0.12358 / 0.2 * 100, rel=1e-4)
    for nothing in (harness.ReaderInput(_trace(glue), {}, CFG, {}),
                    harness.ReaderInput(None, {}, CFG, {})):
        assert _reader("crossing_roofline_pct").read(nothing) is None


class _Recorder:
    def __init__(self):
        self.records, self.next = [], 1

    def span(self, name, start, end, parent=None):
        sid, self.next = self.next, self.next + 1
        request = parent.request if parent else sid
        self.records.append(SpanRecord(name, int(start * MS), int(end * MS), sid,
                                       parent.id if parent else 0, request, 0))
        return self.records[-1]

    def snapshot(self):
        return Snapshot(spans=sorted(self.records, key=lambda s: s.end_ns), counts={},
                        dropped=0)


def _merge(rec, t0, pairs_ms, unpack_ms, tiled=True):
    """One merge at ``t0`` ms: the root, both inversions with two crossing
    passes each, on the tiled route or the fused one."""
    root = rec.span("scan", t0, t0 + 10)
    t = t0
    for _ in range(2):
        inv = rec.span("merge.invert", t, t + 4, root)
        for _ in range(2):
            if tiled:
                rec.span("crossing.pairs", t, t + pairs_ms, inv)
                rec.span("crossing.k6", t + pairs_ms, t + pairs_ms + 0.1, inv)
                rec.span("crossing.unpack", t + 1, t + 1 + unpack_ms, inv)
            else:
                rec.span("crossing.k7", t, t + 0.1, inv)
            t += 2


def test_crossing_glue_reads_the_tiled_spans(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(spans, "snapshot", rec.snapshot)
    for i, (p, u) in enumerate([(0.2, 0.1), (0.4, 0.2), (0.3, 0.15)]):
        _merge(rec, 20.0 * i, p, u)
    _merge(rec, 500.0, 5.0, 5.0)                  # inside the profiled pass
    r = harness.ReaderInput(_trace([("k", 0.499, 0.5)]), {}, CFG, {})
    # four passes a merge; the median merge
    assert _reader("crossing_glue_ms").read(r) == pytest.approx(4 * (0.3 + 0.15))


def test_crossing_glue_is_none_without_its_spans(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(spans, "snapshot", rec.snapshot)
    _merge(rec, 0.0, 0.2, 0.1, tiled=False)       # the fused route
    r = harness.ReaderInput(_trace([("k", 0.499, 0.5)]), {}, CFG, {})
    assert _reader("crossing_glue_ms").read(r) is None
    assert _reader("crossing_glue_ms").read(harness.ReaderInput(None, {}, CFG, {})) is None
    monkeypatch.setattr(spans, "snapshot", lambda: None)     # no recorder
    assert _reader("crossing_glue_ms").read(r) is None


def test_small_tiled_run_is_correct(monkeypatch):
    monkeypatch.setattr(tw, "FUSED_BUDGET", 0)
    monkeypatch.setattr(tw, "_decode", _k1_decode)
    monkeypatch.setattr(fs, "_unwrap_cyclic", _unwrap_rounded_once)
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        torch.manual_seed(0)
        out = harness.run_cell(CELL, 2**31 + 4242, 3.0, False, time.perf_counter(),
                               device="cpu", cfg_override=SMALL, mix_override=SMALL_MIX)
    finally:
        torch.set_num_threads(n)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"scans_per_s", "scan_p95_ms", "setup_s"}
    assert out["checks"]["off_cell_share"]["value"] == 0.0
    assert out["checks"]["truth_rms_mm"]["value"] < 0.05
    assert out["correct"] is True
