"""The three-exposure HDR cell ``scan_stream_hdr3``: its files found by
name, K2's roofline reader on synthetic traces, and the ``scan_stream_hdr``
generator driven end to end on CPU tensors at a small size (the program
takes K2's plain version there): sound, the control and each planted fault
against the limits."""

import time

import pytest
import torch

from portbench import harness, tracing
from portbench.frozen import arith, hdr

CELL = "scan_stream_hdr3"
_, CFG, _, _ = harness.load_cell(CELL)
# a 160x128 camera keeps ~11,000 valid pixels a bracket; half of them ~5,500
SMALL = {"camera": {"width": 160, "height": 128},
         "checks": {**CFG["checks"], "limits": {**CFG["checks"]["limits"],
                                                "valid_pixels_min": 8000}}}
SMALL_MIX = {"pool": 2, "profile_scans": 2}
SEEDS = (2**31 + 77, 2**31 + 4242)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py")


def _trace(device, items=1):
    ops = [tracing.Op(n, s, e) for n, s, e in device]
    return tracing.Trace(device=ops, wall_s=1.0, items=items, host=[], host_device=ops,
                         wall_unprofiled_s=1.0)


def test_the_cell_finds_its_files():
    cell, cfg, mix, gen = harness.load_cell(CELL)
    assert (cell["config"], cell["chips"]) == ("scan_c3_hdr3_u8", 1)
    assert cfg["reduced"] == [] and cfg["name"] == "scan_c3_hdr3_u8"
    assert mix == {"kind": "scan_stream_hdr",
                   "params": {"pool": 8, "prefetch": 2, "spatial_iters": 0, "profile_scans": 500}}
    assert gen.__name__ == "portbench_scan_stream_hdr"
    assert cfg["hdr"] == {"exposures": 3, "gains": [1.0, 3.2, 10.0], "noise_std": 0.003,
                          "albedo": {"cells": 8, "lo": 0.035, "hi": 0.75},
                          "saturation": 0.98, "fuse": "sum"}
    # the rig, the patterns, the decode and the tolerances are scan_c3_u8's
    _, single, _, _ = harness.load_cell("scan_stream")
    for key in ("camera", "projector", "pattern", "frame_dtype", "reconstruct"):
        assert cfg[key] == single[key], key
    for key, value in cfg["decode"].items():
        assert single["decode"][key] == value, key
    assert cfg["checks"]["tolerances"] == single["checks"]["tolerances"]
    bench = harness.manifest()
    e2e = {m["name"] for m in bench["end_to_end"] if harness.reports(m, CELL, bench)}
    layer = {m["name"] for m in bench["per_layer"] if harness.reports(m, CELL, bench)}
    assert e2e == {"scans_per_s", "scan_p95_ms", "setup_s"}
    # the cell reports at least these; device_idle_pct.scan may join them
    # once its reader takes a saturated card's traced busy time
    assert layer >= {"h2d_ms_per_scan", "device_ops_per_scan", "scan_host_ms",
                     "host_wait_ms_per_scan", "host_syncs_per_scan",
                     "idle_in_program_pct.scan", "k2_roofline_pct"}


def test_k2_bytes_at_the_configuration():
    """60 B a pixel: 3 x (white, black, 4 phase frames), 14 Gray frames of
    one exposure, 7 float32 planes; 78.6 MB, 0.0235 ms on the data sheet."""
    H, W = CFG["camera"]["height"], CFG["camera"]["width"]
    n = hdr.k2_bytes(H, W, 3, 4, 7)
    assert n == 60 * 1280 * 1024 == 78_643_200
    assert arith.bound_s(n) == pytest.approx(2.3475e-5, rel=1e-4)


def test_k2_roofline_reads_k2_alone():
    k1 = "void (anonymous namespace)::fused_scan_kernel<unsigned char, 0, false>(...)"
    k2 = ("void (anonymous namespace)::fused_scan_hdr_kernel<unsigned char, 0>"
          "(unsigned char const*, float*, SlrScanParams, int, int)")
    glue = [("Memcpy HtoD (Pinned -> Device)", 0.0, 0.0016), (k1, 0.0, 0.001)]
    ops = glue + [(k2, 0.002 + 0.001 * i, 0.00206 + 0.001 * i) for i in range(4)]
    r = harness.ReaderInput(_trace(ops, items=4), {}, CFG, {})
    # 0.06 ms a launch
    least = arith.bound_s(hdr.k2_bytes(1024, 1280, 3, 4, 7))
    assert _reader("k2_roofline_pct").read(r) == pytest.approx(least / 6e-5 * 100)
    # K1's reader does not take K2's launches
    assert _reader("k1_roofline_pct").read(r) == pytest.approx(
        arith.bound_s(arith.k1_bytes(1024, 1280, 20, 1)) / 0.001 * 100)
    for nothing in (harness.ReaderInput(_trace(glue), {}, CFG, {}),
                    harness.ReaderInput(None, {}, CFG, {}),
                    harness.ReaderInput(_trace(ops), {}, {k: v for k, v in CFG.items()
                                                          if k != "hdr"}, {})):
        assert _reader("k2_roofline_pct").read(nothing) is None


def _traffic(seed):
    _, cfg, mix, gen = harness.load_cell(CELL)
    cfg.update(SMALL)
    traffic = gen.Traffic(cfg, {**mix["params"], **SMALL_MIX}, seed, "cpu")
    traffic.setup()
    traffic.window(0.3, sync_spans=False)
    return traffic, cfg["checks"]["limits"]


@pytest.mark.parametrize("seed", SEEDS)
def test_small_run_is_correct(seed):
    torch.manual_seed(0)
    out = harness.run_cell(CELL, seed, 0.5, False, time.perf_counter(), device="cpu",
                           cfg_override=SMALL, mix_override=SMALL_MIX)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"scans_per_s", "scan_p95_ms", "setup_s"}
    assert out["checks"]["off_pixel_share"]["value"] == 0.0
    assert out["checks"]["valid_pixels_min"]["value"] > 10_000
    assert out["correct"] is True


def test_control_and_each_fault_fail_a_limit():
    """The reference in TF32 in the program's place, and each planted
    fault: the longest exposure from the next bracket, the best exposure's
    phase alone, the lower half of each cloud dropped."""
    traffic, limits = _traffic(SEEDS[0])
    try:
        faults = traffic.fault_readings()
        control = traffic.control_readings()
    finally:
        traffic.close()
    assert set(faults) == {"long_from_next", "select", "half_pixels"}
    for name, got in [("control", control), *faults.items()]:
        checks = harness.limits_check(got, limits)
        assert not all(c[3] for c in checks), name
        assert got["off_pixel_share"] > limits["off_pixel_share"], name
    assert faults["half_pixels"]["valid_pixels_min"] < limits["valid_pixels_min"]


def test_a_bracket_left_unfused_is_not_correct(monkeypatch):
    """The stream's brackets reconstructed from the shortest exposure alone."""
    import slr_torch.pipeline.stream as stream

    hdr_route = stream.reconstruct_scan_hdr
    monkeypatch.setattr(stream, "reconstruct_scan_hdr",
                        lambda stacks, *a, **k: hdr_route(stacks[:1], *a, **k))
    out = harness.run_cell(CELL, SEEDS[0], 0.3, False, time.perf_counter(), device="cpu",
                           cfg_override=SMALL, mix_override=SMALL_MIX)
    assert out["correct"] is False
    assert out["checks"]["off_pixel_share"]["value"] > out["checks"]["off_pixel_share"]["limit"]
