"""The two-camera cell on CPU tensors at a small size (a 256x192 rig and
projector, 5 + 5 Gray bits, 3-step phase on both axes: the size and
pattern of ``tests/test_torch_twocam.py``): the frozen synth against the
program's, the plain reference against the program, the control against
the limits, and runs with the timed path broken underneath, each of which
has to come out not correct.

On the card the merge decodes with K1's decode-only route; on a CPU tensor
``reconstruct_two_camera`` decodes with ``decode_stack`` (normalised
floats), whose x_p differs from K1's by an ulp now and then, which moves
a crossing from one pair to the next and its nearest-carried quality and
colour by a pixel's noise. K1's plain version (``fused_decode_triangulate``
on a CPU tensor) rounds ``phi + 2 pi order`` twice where the card's fused
multiply-add rounds it once, as the reference does. So the program is held
to the reference here with its decode taken by K1's plain version with the
card's rounding, the arithmetic the card runs; the unchanged CPU route is
held to the reference's masks and points.
"""

import math
import time

import pytest
import torch

from portbench import harness
from portbench.frozen import twocam as frozen
from portbench.reference import twocam as ref
from slr_torch.codec.patterns import DecodeResult
from slr_torch.config import PatternConfig
from slr_torch.kernels import fused_scan as fs
from slr_torch.kernels.fused_scan import fused_decode_triangulate
from slr_torch.pipeline import twocam as tw
from slr_torch.synth import render as prog_render
from slr_torch.synth import scene as prog_scene

CAM_W, CAM_H = 256, 192
PROJ_W, PROJ_H = 256, 192
PATTERN = dict(proj_width=PROJ_W, proj_height=PROJ_H, gray_bits=5, row_gray_bits=5,
               phase_steps=3, row_phase_steps=3)
_, CFG, _, _ = harness.load_cell("merge_twocam_u8")
# the source's floor of valid cells is 71 % of its projector grid; the
# small grid is held to half of its cells
SMALL = {"camera": {**CFG["camera"], "width": CAM_W, "height": CAM_H},
         "projector": {"width": PROJ_W, "height": PROJ_H},
         "pattern": {"coding": "gray_phase", "gray_bits": 5, "row_gray_bits": 5,
                     "use_inverse": True, "phase_steps": 3, "row_phase_steps": 3, "frames": 28},
         "checks": {**CFG["checks"], "limits": {**CFG["checks"]["limits"],
                                                "valid_cells_min": PROJ_W * PROJ_H // 2}}}
SMALL_MIX = {"pool": 3, "profile_scans": 2}
SEEDS = (2**31 + 77, 5, 2**31 + 999)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _k1_decode(frames, cam, cfg, dec):
    o = fused_decode_triangulate(frames, cam, None, cfg, dec, decode_only=True)
    return DecodeResult(x_p=o.x_p, y_p=o.y_p, mask=o.mask > 0.5, quality=o.quality)


def _unwrap_rounded_once(phi, code, bits, scale, period, fold):
    """K1's unwrap as the card computes it: phi + 2 pi order in one fused
    multiply-add (the plain version rounds the product and the sum)."""
    order = code - (phi >= math.pi).to(torch.int32)
    order = torch.where(order < 0, order + (1 << bits), order)
    two_pi = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))
    x = (phi.double() + two_pi * order.double()).float() * scale
    return torch.where(x > fold, x - period, x)


@pytest.fixture
def k1_route(monkeypatch):
    """The merge decoding by K1's plain version with the card's rounding."""
    monkeypatch.setattr(tw, "_decode", _k1_decode)
    monkeypatch.setattr(fs, "_unwrap_cyclic", _unwrap_rounded_once)


def _traffic(seed):
    _, cfg, mix, gen = harness.load_cell("merge_twocam_u8")
    cfg.update(SMALL)
    traffic = gen.Traffic(cfg, {**mix["params"], **SMALL_MIX}, seed, "cpu")
    traffic.setup()
    return traffic


def _run(seed=SEEDS[0], seconds=0.5):
    torch.manual_seed(0)
    return harness.run_cell("merge_twocam_u8", seed, seconds, False, time.perf_counter(),
                            device="cpu", cfg_override=SMALL, mix_override=SMALL_MIX)


def test_frozen_render_matches_the_program():
    prog = prog_render.two_camera_rig(CAM_W, CAM_H, PROJ_W, PROJ_H)
    mine = frozen.two_camera_rig(CAM_W, CAM_H, PROJ_W, PROJ_H)
    for a, b in zip(prog, mine):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    cfg = PatternConfig(**PATTERN)
    plane = (3.5, -7.25, 569.0)
    spheres = (((23.5, -2.25, 549.0), 140.0), ((-56.5, -47.25, 529.0), 60.0))
    for i, (pc, c) in enumerate(zip(prog[:2], mine[:2])):
        for scene in ({}, {"plane_point": plane, "spheres": spheres}):
            depth = frozen.spheres_scene(c, CAM_H, CAM_W, **scene)
            assert torch.equal(depth, prog_scene.spheres_scene(pc, CAM_H, CAM_W, **scene))
            want = prog_render.render_scan(pc, prog[2], depth, cfg, noise_std=0.003,
                                           cast_shadows=True,
                                           generator=torch.Generator().manual_seed(20 + i))
            got = frozen.render_pair_scan(c, mine[2], depth, PROJ_W, PROJ_H, 5, 5, 3, 3,
                                          noise_std=0.003,
                                          generator=torch.Generator().manual_seed(20 + i))
            assert not bool(want.mask_true.all())          # the spheres cast shadows
            assert torch.equal(got.frames, want.frames)
            assert torch.equal(got.mask_true, want.mask_true)
            assert torch.equal(frozen.quantize_frames(got.frames),
                               prog_render.quantize_frames(want.frames))


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_equals_the_program(seed, k1_route):
    traffic = _traffic(seed)
    for k in range(len(traffic.pool)):
        got = traffic._judged(traffic._scan(k))
        want = traffic.reference(k)
        assert int(got[1].sum()) > SMALL["checks"]["limits"]["valid_cells_min"]
        assert ref.off_cell_share(got, want, CFG["checks"]["tolerances"]) == 0.0
        # the same arithmetic, rounding for rounding: the same bits
        for a, b in zip(got, (want.points, want.mask, want.colors, want.quality)):
            assert torch.equal(a, b)


def test_reference_agrees_with_the_cpu_route():
    """The unchanged CPU route: masks equal on all but a few cells, and
    every point valid in both within its tolerance."""
    traffic = _traffic(SEEDS[1])
    tol = CFG["checks"]["tolerances"]["points_mm"]
    for k in range(len(traffic.pool)):
        got, want = traffic._scan(k), traffic.reference(k)
        assert float((got.mask != want.mask).float().mean()) <= 1e-4
        both = got.mask & want.mask
        assert float(torch.linalg.norm(got.points - want.points, dim=-1)[both].max()) <= tol


def test_sound_run_is_correct(k1_route):
    # long enough for every pool pair to be merged, and so judged, at least once
    out = _run(seconds=3.0)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"scans_per_s", "scan_p95_ms", "setup_s"}
    assert out["checks"]["off_cell_share"]["value"] == 0.0
    assert out["checks"]["truth_rms_mm"]["value"] < 0.05
    assert out["correct"] is True
    assert list(out)[-1] == "checks"


def test_control_fails_a_limit():
    """The reference in TF32 in the program's place is not correct."""
    traffic = _traffic(SEEDS[2])
    got = traffic.control_readings()
    limits = SMALL["checks"]["limits"]
    assert got["off_cell_share"] > limits["off_cell_share"], got


def test_planted_faults_fail_a_limit(k1_route):
    traffic = _traffic(SEEDS[0])
    traffic.window(0.5, sync_spans=False)
    faults = traffic.fault_readings()
    limits = SMALL["checks"]["limits"]
    assert set(faults) == {"swapped_camera", "half_cells"}
    for name, got in faults.items():
        assert got["off_cell_share"] > limits["off_cell_share"], name
    assert faults["half_cells"]["valid_cells_min"] < limits["valid_cells_min"]


def _moved(fn):
    """The midpoints moved by 0.05 mm on a block of cells where they are
    produced."""
    def run(*a, **k):
        pts, gap = fn(*a, **k)
        pts = pts.clone()
        pts[40:56, 60:80] += 0.05
        return pts, gap
    return run


def _half_found(fn):
    """Each camera's inversion with the lower half of the projector rows
    left out."""
    def run(*a, **k):
        found, *rest = fn(*a, **k)
        found = found.clone()
        found[found.shape[0] // 2:] = False
        return (found, *rest)
    return run


def _one_camera(fn):
    """Camera 2's stack left out of the pair: camera 1's merged with itself."""
    def run(f1, f2, *a, **k):
        return fn(f1, f1, *a, **k)
    return run


@pytest.mark.parametrize("name,patch", [("triangulate_midpoint", _moved),
                                        ("invert_to_projector", _half_found),
                                        ("reconstruct_two_camera", _one_camera)])
def test_broken_merge_is_not_correct(monkeypatch, k1_route, name, patch):
    monkeypatch.setattr(tw, name, patch(getattr(tw, name)))
    out = _run(seconds=0.3)
    assert out["correct"] is False
    check = out["checks"]["off_cell_share"]
    assert check["value"] > check["limit"], name


def test_mix_parameters():
    cell, cfg, mix, gen = harness.load_cell("merge_twocam_u8")
    assert (cell["config"], cell["chips"]) == ("twocam_1280x1024", 1)
    assert mix == {"kind": "twocam_stream", "params": {"pool": 8, "profile_scans": 200}}
    assert gen.__name__ == "portbench_twocam_stream"
    pat = cfg["pattern"]
    assert pat["frames"] == 2 + 2 * pat["gray_bits"] + 2 * pat["row_gray_bits"] \
        + pat["phase_steps"] + pat["row_phase_steps"] == 36
    assert cfg["method"] == "merge" and cfg["frame_dtype"] == "uint8"
