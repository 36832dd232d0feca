"""Exposure brackets on the stream's normal path (CPU): ``reconstruct_stream``
on (E, F, H, W) uint8 brackets against the benchmark's plain reference of
the HDR fuse (``portbench/reference/hdr.py``) and against
``reconstruct_scan_hdr``'s own bits; a stream that mixes single stacks and
brackets; the repair refused on a bracket; the span tree of a bracket; and
the bracket's colours, converted at once, against each exposure's white
frame converted on its own, on every count a camera gives.

The brackets are 160x128, three independent uint8 captures at the gains
1, 3.2 and 10 of a 21x-albedo checkerboard, as the benchmark builds its
bracket. Imports no JAX.
"""

import pytest
import torch

from portbench.reference import hdr as ref_hdr
from portbench.reference import scan as ref_scan
from slr_torch import observability as obs
from slr_torch.config import DecodeConfig, PatternConfig, ReconstructConfig
from slr_torch.pipeline import reconstruct as trec
from slr_torch.pipeline import reconstruct_stream
from slr_torch.synth.render import default_rig, quantize_frames, render_scan
from slr_torch.synth.scene import bumps_depth, checker_albedo
from test_torch_observability import _tree

torch.set_num_threads(2)

W, H = 160, 128
CFG = PatternConfig(proj_width=256, proj_height=192, gray_bits=5, phase_steps=4)
DEC = DecodeConfig()
REC = ReconstructConfig()
GAINS = (1.0, 3.2, 10.0)
SEEDS = (3, 11)
TOL = {"points_mm": 0.01, "x_p_px": 0.001, "quality": 1e-05}


def _bracket(seed):
    """(cam, proj, uint8 (3, F, H, W) bracket, its single unit-gain stack)."""
    cam, proj = default_rig(cam_w=W, cam_h=H, proj_w=256, proj_h=192)
    scan = render_scan(cam, proj, bumps_depth(H, W, base=480.0, amp=25.0), CFG,
                       albedo=checker_albedo(H, W, cells=6, lo=0.035, hi=0.75))
    gen = torch.Generator().manual_seed(seed)
    bracket = torch.stack([quantize_frames(torch.clamp(
        scan.frames * g + 0.003 * torch.randn(scan.frames.shape, generator=gen), 0.0, 1.0))
        for g in GAINS])
    return cam, proj, bracket, quantize_frames(scan.frames)


def _stream(stacks, cam, proj, **kw):
    return list(reconstruct_stream(iter(stacks), cam, proj, CFG, DEC, REC, device="cpu", **kw))


def _bits_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_bracket_route_matches_the_reference(seed):
    cam, proj, bracket, _ = _bracket(seed)
    (cloud,) = _stream([bracket], cam, proj)
    ref = ref_hdr.decode_bracket(bracket, ref_scan.rig_of(cam, proj), CFG.gray_bits,
                                 CFG.phase_steps, CFG.proj_width,
                                 {"black_threshold": DEC.black_threshold,
                                  "white_threshold": DEC.white_threshold,
                                  "modulation_threshold": DEC.modulation_threshold},
                                 0.98, REC.min_depth, REC.max_depth)
    assert torch.equal(cloud.mask, ref.mask)
    assert cloud.mask.float().mean() > 0.4
    got = (cloud.points, cloud.mask, cloud.colors, cloud.quality, cloud.x_p)
    assert ref_scan.off_pixel_share(got, ref, TOL) == 0.0


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_bracket_has_the_bits_of_reconstruct_scan_hdr(seed):
    cam, proj, bracket, _ = _bracket(seed)
    for prefetch in (1, 2):
        got = _stream([bracket, bracket.numpy()], cam, proj, prefetch=prefetch)
        assert len(got) == 2
        for cloud in got:
            _bits_equal(cloud, trec.reconstruct_scan_hdr(bracket, cam, proj, CFG, DEC, REC))


def test_a_mixed_stream_routes_each_stack():
    cam, proj, bracket, single = _bracket(SEEDS[0])
    stacks = [single, bracket, single.numpy(), bracket]
    got = _stream(stacks, cam, proj, prefetch=2)
    assert len(got) == 4
    for s, cloud in zip(stacks, got):
        s = torch.as_tensor(s)
        want = (trec.reconstruct_scan_hdr(s, cam, proj, CFG, DEC, REC) if s.dim() == 4
                else trec.reconstruct_dense(s, cam, proj, CFG, DEC, REC))
        _bits_equal(cloud, want)
    # the bracket's fuse and the single stack's decode differ
    assert not torch.equal(got[0].mask, got[1].mask)


def test_a_bracket_with_the_repair_raises():
    cam, proj, bracket, single = _bracket(SEEDS[0])
    with pytest.raises(ValueError, match="no spatial repair"):
        next(reconstruct_stream(iter([bracket]), cam, proj, CFG, spatial_iters=4,
                                device="cpu"))
    # behind a single stack: refused when it is enqueued, behind that
    # stack's launches and before its cloud is handed out
    with pytest.raises(ValueError, match="no spatial repair"):
        next(reconstruct_stream(iter([single, bracket]), cam, proj, CFG, prefetch=1,
                                spatial_iters=4, device="cpu"))
    assert len(_stream([single, single], cam, proj, spatial_iters=4)) == 2
    # the module routes by the same rule
    with pytest.raises(ValueError, match="no spatial repair"):
        trec.DenseReconstructor(cam, proj, CFG, spatial_iters=4)(bracket)


def test_the_bracket_span_tree():
    """One ``scan`` root a bracket, its colour glue under ``hdr.colors``;
    the CPU takes K2's plain version, so no parameter block is read: no
    wait. Through the stream, each scan belongs to its enqueue's request."""
    cam, proj, bracket, _ = _bracket(SEEDS[0])
    mark = max((s.id for s in obs.snapshot().spans), default=0)
    trec.reconstruct_scan_hdr(bracket, cam, proj, CFG)
    spans = [s for s in obs.snapshot().spans if s.id > mark]
    assert _tree(spans) == [("scan", [("hdr.colors", [])])]
    assert sum(s.wait for s in spans) == 0
    mark = max(s.id for s in spans)
    _stream([bracket, bracket], cam, proj, prefetch=1)
    spans = [s for s in obs.snapshot().spans if s.id > mark]
    scan = ("scan", [("hdr.colors", [])])
    assert _tree(spans) == [("stream.enqueue", []), scan, ("stream.enqueue", []), scan]
    enq = sorted((s for s in spans if s.name == "stream.enqueue"), key=lambda s: s.id)
    scans = sorted((s for s in spans if s.name == "scan"), key=lambda s: s.id)
    assert [s.request for s in scans] == [e.id for e in enq]


@pytest.mark.parametrize("dtype,bits,saturation", [
    (torch.uint8, 8, 0.98), (torch.uint8, 8, 0.5), (torch.uint8, 8, 1.0), (torch.uint8, 8, 1.5),
    (torch.uint16, 8, 0.98), (torch.uint16, 12, 0.98), (torch.uint16, 16, 0.98),
    (torch.uint16, 16, 0.5), (torch.uint16, 16, 1.0), (torch.uint16, 10, 0.98)])
def test_bracket_colors_in_counts_are_the_float_formula(dtype, bits, saturation):
    """Every count of a ``bits``-bit camera, in each exposure of a 3-exposure
    bracket (in three orders), against comparing and reducing each white
    frame converted to [0, 1] on its own, bit for bit."""
    n = 1 << bits
    c = torch.arange(n, dtype=torch.int64)
    whites = torch.stack([c, (c * 7 + 3) % n, c.flip(0)])
    stacks = whites[:, None, None, :].to(torch.int32).to(dtype)       # (3, 1, 1, n)
    got = trec._bracket_colors(stacks, saturation)
    w = torch.stack([trec._white_color(s) for s in stacks])
    want = torch.where(w < saturation, w, 0.0).amax(dim=0)
    assert got.dtype == torch.float32 and torch.equal(got, want)
