"""The port's CUDA kernels (K1, every branch, K2, the spatial repair's K3, K4
and K5, the band search K8, and the crossing kernels K6 and K7 of the
two-camera merge) against their plain PyTorch versions, on the card; and
config 5's voxel merge, whose ordered segment sum must give the same bits
in every call there; and calibration (config 2) on the card: the LM loop
with no host synchronisation, the solves and the corner detector against
the CPU; and the product surface: the stream's side-stream copy,
``nan_guard`` on card tensors and the session on the card against the
session on the CPU.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import (box_exposures, corner_fronts, cu_constant, hdr_best_exposure, k2_box,
                        long_range_pairs)
from slr_torch.codec import unwrap as pu
from slr_torch.config import DecodeConfig, PatternConfig
from slr_torch.geom.camera import make_camera
from slr_torch.kernels import band_nn as kb
from slr_torch.kernels import crossing as kx
from slr_torch.kernels import fused_scan as fs
from slr_torch.kernels import unwrap_scan as us
from slr_torch.kernels import wavefront as wf
from slr_torch.pipeline.reconstruct import (
    DenseReconstructor, accumulate_by_projector, spatial_repair)
from slr_torch.pipeline.twocam import reconstruct_two_camera
from slr_torch.registration import band as rb
from slr_torch.registration.icp import icp_point_to_plane
from slr_torch.synth.render import (
    default_rig, quantize_frames, render_scan, two_camera_rig)
from slr_torch.synth.scene import bumps_depth, checker_albedo, spheres_scene

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _scan(device, w, h, noise):
    cam, proj = default_rig(cam_w=w, cam_h=h, proj_w=256, proj_h=192,
                            baseline=150.0, toe_in_deg=14.0, device=device)
    cfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=6,
                        phase_steps=4)
    gen = torch.Generator(device=device).manual_seed(1)
    scan = render_scan(cam, proj, bumps_depth(h, w, base=480.0, amp=25.0,
                                              device=device),
                       cfg, noise_std=noise, generator=gen)
    return cam, proj, cfg, scan


@pytest.mark.parametrize("w,h,noise", [(320, 256, 0.005), (300, 215, 0.0)])
def test_kernel_matches_plain_version(cuda, w, h, noise):
    cam, proj, cfg, scan = _scan(cuda, w, h, noise)
    dec = DecodeConfig()
    before = fs.fused_decode_triangulate.launches
    k = fs.fused_decode_triangulate(scan.frames, cam, proj, cfg, dec)
    assert fs.fused_decode_triangulate.launches == before + 1
    p = fs.fused_decode_triangulate_reference(scan.frames, cam, proj, cfg, dec)
    torch.cuda.synchronize()
    mk, mp = k.mask > 0.5, p.mask > 0.5
    # FMA contraction, sum order and the device atan2f can flip a code bit
    # only on pixels sitting exactly on a code edge: bound fractions
    assert float((mk ^ mp).float().mean()) <= 1e-3
    both = mk & mp
    assert float(both.float().mean()) > 0.3
    dx = (k.x_p - p.x_p).abs()
    assert float((both & (dx > 1e-3)).sum()) <= 1e-4 * float(both.sum())
    agree = both & (dx <= 1e-3)
    assert float((k.points - p.points).abs().amax(0)[agree].max()) <= 1e-2
    assert float((k.quality - p.quality).abs().max()) <= 1e-5
    assert float(k.y_p.abs().max()) == 0.0
    assert not bool(torch.isnan(k.points).any())


def test_dense_reconstructor_launches_kernel_once(cuda):
    cam, proj, cfg, scan = _scan(torch.device("cpu"), 320, 256, 0.0)
    model = DenseReconstructor(cam, proj, cfg).to(cuda)
    frames = scan.frames.to(cuda)
    fs.fused_decode_triangulate.launches = 0
    cloud = model(frames)
    torch.cuda.synchronize()
    assert fs.fused_decode_triangulate.launches == 1
    valid = cloud.mask.cpu() & scan.mask_true
    err = torch.linalg.norm(cloud.points.cpu() - scan.points_true, dim=-1)[valid]
    assert float(err.square().mean().sqrt()) < 0.5
    # index_add_ on the card sums with atomics in a varying order:
    # relative 1e-5 against the CPU's sums of the same cloud
    on_card = accumulate_by_projector(cloud, 256)
    on_cpu = accumulate_by_projector(type(cloud)(*(x.cpu() for x in cloud)), 256)
    assert torch.equal(on_card[1].cpu(), on_cpu[1])
    for a, b in ((on_card[0], on_cpu[0]), (on_card[2], on_cpu[2])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


def test_kernel_rejects_bad_input(cuda):
    cam, proj, cfg, scan = _scan(cuda, 64, 48, 0.0)
    params = fs.scan_params(cam, proj, cfg, DecodeConfig(), (1.0, 1e4), 8, 48, 64)
    with pytest.raises(ValueError, match="contiguous"):
        fs.launch_fused_scan(scan.frames.transpose(1, 2), params)
    with pytest.raises(ValueError, match="do not match"):
        fs.launch_fused_scan(scan.frames[:, :40].contiguous(), params)


PROJ = dict(proj_width=256, proj_height=192)
BRANCHES = {
    "uint8": dict(gray_bits=6, phase_steps=4),
    "uint16_bit_depth_12": dict(gray_bits=6, phase_steps=4),
    "gray_only": dict(gray_bits=7, phase_steps=0),
    "midpoint": dict(gray_bits=6, row_gray_bits=6, phase_steps=4),
    "midpoint_row_phase": dict(gray_bits=6, row_gray_bits=6, phase_steps=4,
                               row_phase_steps=4),
    "multifreq": dict(coding="multifreq", phase_steps=4, mf_levels=3,
                      mf_ratio=6.0),
    "decode_only": dict(gray_bits=6, row_gray_bits=5, phase_steps=4,
                        row_phase_steps=4),
}


def _agrees(k, p, rows):
    """The tolerances of test_kernel_matches_plain_version, with y_p held
    like x_p where rows are coded."""
    mk, mp = k.mask > 0.5, p.mask > 0.5
    assert float((mk ^ mp).float().mean()) <= 1e-3
    both = mk & mp
    assert float(both.float().mean()) > 0.3
    off = (k.x_p - p.x_p).abs() > 1e-3
    if rows:
        off = off | ((k.y_p - p.y_p).abs() > 1e-3)
    else:
        assert float(k.y_p.abs().max()) == 0.0
    assert float((both & off).sum()) <= 1e-4 * float(both.sum())
    agree = both & ~off
    assert float((k.points - p.points).abs().amax(0)[agree].max()) <= 1e-2
    assert float((k.quality - p.quality).abs().max()) <= 1e-5
    assert not bool(torch.isnan(k.points).any())


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_kernel_branch_matches_plain_version(cuda, branch):
    cfg = PatternConfig(**PROJ, **BRANCHES[branch])
    midpoint = branch.startswith("midpoint")
    cam, proj = default_rig(cam_w=320, cam_h=256, proj_w=256, proj_h=192,
                            baseline=150.0, toe_in_deg=14.0, device=cuda,
                            proj_dist=([-0.08, 0.02, 0.001, -0.001, 0.0]
                                       if midpoint else None))
    gen = torch.Generator(device=cuda).manual_seed(2)
    frames = render_scan(cam, proj, bumps_depth(256, 320, base=480.0, amp=25.0,
                                                device=cuda),
                         cfg, noise_std=0.0 if midpoint else 0.005,
                         generator=gen).frames
    kw = {}
    if branch in ("uint8", "decode_only"):
        frames = quantize_frames(frames)
    elif branch == "uint16_bit_depth_12":
        frames = torch.clamp(torch.round(frames * 4095), 0, 4095).to(torch.uint16)
        kw = dict(bit_depth=12)
    if branch == "decode_only":  # a posed camera, no projector model
        cam = make_camera(cam.fx, cam.fy, cam.cx, cam.cy, R=proj.R, t=proj.t,
                          device=cuda)
        proj, kw = None, dict(decode_only=True)
    dec = DecodeConfig()
    before = fs.fused_decode_triangulate.launches
    k = fs.fused_decode_triangulate(frames, cam, proj, cfg, dec, **kw)
    assert fs.fused_decode_triangulate.launches == before + 1
    p = fs.fused_decode_triangulate_reference(frames, cam, proj, cfg, dec, **kw)
    torch.cuda.synchronize()
    _agrees(k, p, rows=cfg.row_gray_bits > 0)
    if branch == "decode_only":
        assert float(k.points.abs().max()) == 0.0


@pytest.mark.parametrize("dtype,w,h,offset", [
    ("uint8", 299, 215, 0), ("uint8", 301, 215, 0), ("uint16", 299, 215, 0),
    ("uint16", 301, 215, 0), ("uint8", 1296, 215, 0), ("uint16", 1296, 215, 0),
    ("uint8", 320, 256, 3), ("uint16", 1280, 1024, 0)])
def test_integer_kernel_layouts_match_plain_version(cuda, dtype, w, h, offset):
    """The kernel stages 128 x 2 boxes by 16-byte copies where the rows are
    16-byte aligned and the box lies whole inside the map, and decodes from
    device memory elsewhere: rows of 299 and 301 pixels (not a multiple of
    16 bytes), 1296 = 10 * 128 + 16 columns (aligned, a partial last box),
    215 rows (a partial last box row), a uint8 stack 3 bytes into its
    buffer, and 12-bit data at full size, each held to the plain version
    with the float32 tolerances."""
    cam, proj, cfg, scan = _scan(cuda, w, h, 0.005)
    kw = {}
    if dtype == "uint8":
        frames = quantize_frames(scan.frames)
    else:
        frames = torch.clamp(torch.round(scan.frames * 4095), 0, 4095).to(torch.uint16)
        kw = dict(bit_depth=12)
    if offset:
        buf = torch.empty(frames.numel() + offset, dtype=frames.dtype, device=cuda)
        buf[offset:] = frames.reshape(-1)
        frames = buf[offset:].view(frames.shape)
        assert frames.is_contiguous() and frames.data_ptr() % 4 == offset
    dec = DecodeConfig()
    before = fs.fused_decode_triangulate.launches
    k = fs.fused_decode_triangulate(frames, cam, proj, cfg, dec, **kw)
    assert fs.fused_decode_triangulate.launches == before + 1
    p = fs.fused_decode_triangulate_reference(frames, cam, proj, cfg, dec, **kw)
    torch.cuda.synchronize()
    _agrees(k, p, rows=False)


def _bracket(device, gains=(1.0, 3.2, 10.0)):
    cam, proj = default_rig(cam_w=320, cam_h=256, proj_w=256, proj_h=192,
                            device=device)
    cfg = PatternConfig(**PROJ, gray_bits=5, phase_steps=4)
    scan = render_scan(cam, proj, bumps_depth(256, 320, base=480.0, amp=25.0,
                                              device=device), cfg,
                       albedo=checker_albedo(256, 320, cells=6, lo=0.035,
                                             hi=0.75, device=device))
    gen = torch.Generator(device=device).manual_seed(5)
    bracket = torch.stack([quantize_frames(torch.clamp(
        scan.frames * g + 0.003 * torch.randn(scan.frames.shape, generator=gen,
                                              device=device), 0.0, 1.0))
        for g in gains])
    return cam, proj, cfg, scan, bracket


@pytest.mark.parametrize("fuse", ["sum", "select"])
def test_hdr_kernel_matches_plain_version(cuda, fuse):
    cam, proj, cfg, _, bracket = _bracket(cuda)
    dec = DecodeConfig()
    before = fs.fused_decode_triangulate_hdr.launches
    k = fs.fused_decode_triangulate_hdr(bracket, cam, proj, cfg, dec, fuse=fuse)
    assert fs.fused_decode_triangulate_hdr.launches == before + 1
    p = fs.fused_decode_triangulate_hdr_reference(bracket, cam, proj, cfg, dec,
                                                  fuse=fuse)
    torch.cuda.synchronize()
    _agrees(k, p, rows=False)


@pytest.mark.parametrize("case", ["mixed_boxes", "uint16", "float32", "uint8_299x215",
                                  "uint8_301x215", "uint8_offset3"])
def test_hdr_kernel_layouts_match_plain_version(cuda, case):
    """K2 stages 128 x 2 boxes of the bracket in two rounds (every pixel's
    frames, then the Gray frames of the exposures the box chose) where a
    16-byte copy takes a box whole, and decodes from device memory
    elsewhere: a bracket whose chosen exposure changes inside most boxes
    (squares ~3 px wide), 12-bit data in uint16, float32, rows of 299 and
    301 pixels, and a bracket 3 bytes off alignment; both fusions, with the
    float32 tolerances."""
    w, h = (299, 215) if case == "uint8_299x215" else (301, 215) if case.endswith("301x215") \
        else (320, 256)
    cam, proj = default_rig(cam_w=w, cam_h=h, proj_w=256, proj_h=192, device=cuda)
    cfg = PatternConfig(**PROJ, gray_bits=5, phase_steps=4)
    cells = w // 3 if case == "mixed_boxes" else 6
    scan = render_scan(cam, proj, bumps_depth(h, w, base=480.0, amp=25.0, device=cuda), cfg,
                       albedo=checker_albedo(h, w, cells=cells, lo=0.035, hi=0.75,
                                             device=cuda))
    gen = torch.Generator(device=cuda).manual_seed(5)
    bracket = torch.stack([torch.clamp(scan.frames * g + 0.003 * torch.randn(
        scan.frames.shape, generator=gen, device=cuda), 0.0, 1.0) for g in (1.0, 3.2, 10.0)])
    kw = {}
    if case == "uint16":
        bracket = torch.clamp(torch.round(bracket * 4095), 0, 4095).to(torch.uint16)
        kw = dict(bit_depth=12)
    elif case != "float32":
        bracket = quantize_frames(bracket)
    if case == "uint8_offset3":
        buf = torch.empty(bracket.numel() + 3, dtype=torch.uint8, device=cuda)
        buf[3:] = bracket.reshape(-1)
        bracket = buf[3:].view(bracket.shape)
        assert bracket.is_contiguous() and bracket.data_ptr() % 4 == 3
    if case == "mixed_boxes":
        chosen = box_exposures(hdr_best_exposure(bracket, cfg, DecodeConfig()), 3, k2_box())
        assert float((chosen >= 2).float().mean()) > 0.5
    dec = DecodeConfig()
    for fuse in ("sum", "select"):
        before = fs.fused_decode_triangulate_hdr.launches
        k = fs.fused_decode_triangulate_hdr(bracket, cam, proj, cfg, dec, fuse=fuse, **kw)
        assert fs.fused_decode_triangulate_hdr.launches == before + 1
        p = fs.fused_decode_triangulate_hdr_reference(bracket, cam, proj, cfg, dec, fuse=fuse,
                                                      **kw)
        torch.cuda.synchronize()
        _agrees(k, p, rows=False)


def test_dense_reconstructor_launches_once_on_uint8_and_bracket(cuda):
    cam, proj, cfg, scan, bracket = _bracket(torch.device("cpu"))
    model = DenseReconstructor(cam, proj, cfg).to(cuda)
    # the unit-gain exposure alone (no saturated cells), then the bracket
    for frames, k1, k2 in ((bracket[0], 1, 0), (bracket, 0, 1)):
        fs.fused_decode_triangulate.launches = 0
        fs.fused_decode_triangulate_hdr.launches = 0
        cloud = model(frames.to(cuda))
        torch.cuda.synchronize()
        assert (fs.fused_decode_triangulate.launches,
                fs.fused_decode_triangulate_hdr.launches) == (k1, k2)
        valid = cloud.mask.cpu() & scan.mask_true
        err = torch.linalg.norm(cloud.points.cpu() - scan.points_true, dim=-1)[valid]
        assert float(err.square().mean().sqrt()) < 0.5


def _phase_map(device, H, W, seed, partial=False, blob=False):
    """A ramp with noise and isolated pixels 3 fringe orders off (and a
    6x8 blob); ``partial``: a mask with holes and bad pixels on the
    borders. Returns (clean Phi, Phi with errors, quality, mask, bad)."""
    rng = np.random.default_rng(seed)
    Phi = (np.linspace(0, 40, W)[None, :]
           + 0.1 * rng.normal(size=(H, W))).astype(np.float32)
    bad = np.zeros((H, W), bool)
    n_bad = max(1, H * W // 200)
    bad[rng.integers(1, H - 1, n_bad), rng.integers(1, W - 1, n_bad)] = True
    mask = np.ones((H, W), bool)
    if partial:
        mask = rng.random((H, W)) > 0.1
        bad[0, ::7] = bad[H - 1, ::5] = bad[::6, 0] = bad[::4, W - 1] = True
    if blob:
        bad[H // 3:H // 3 + 6, W // 4:W // 4 + 8] = True
    q = np.where(bad, 0.05, 1.0).astype(np.float32)
    Phi_n = np.where(bad, Phi + np.float32(6 * math.pi), Phi).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (Phi, Phi_n, q, mask, bad)]


@pytest.mark.parametrize("H,W,iters,partial", [
    (64, 96, 6, False), (215, 300, 8, True), (130, 200, 12, True), (3, 50, 3, False)])
def test_vote_kernels_match_plain_version(cuda, H, W, iters, partial):
    """K3 and K4 equal the plain sweep bit for bit, on the card and against
    the CPU; K4 with more sweeps than its halo takes one launch per chunk."""
    _, Phi_n, q, mask, _ = _phase_map(cuda, H, W, 0, partial)
    plain = pu.spatial_quality_unwrap(Phi_n, q, mask, iters)
    assert torch.equal(plain.cpu(), pu.spatial_quality_unwrap(
        Phi_n.cpu(), q.cpu(), mask.cpu(), iters))
    before = (us.quality_unwrap.launches, us.quality_unwrap_tiled.launches)
    k3 = us.launch_vote_resident(Phi_n, mask, iters)
    assert us.quality_unwrap.launches == before[0] + 1
    for tile_h, halo in ((64, None), (16, 5), (128, 8)):
        n = us.quality_unwrap_tiled.launches
        k4 = us.quality_unwrap_tiled(Phi_n, q, mask, iters, tile_h=tile_h, halo=halo)
        chunk = halo or min(iters, us.MAX_HALO)
        assert us.quality_unwrap_tiled.launches - n == -(-iters // chunk)
        torch.cuda.synchronize()
        assert torch.equal(k4, plain), (tile_h, halo)
    assert torch.equal(k3, plain)
    assert not torch.equal(plain, Phi_n)


def _tie_map(device, H, W, seed):
    """A checkerboard of 0 and values y whose quotient y / 2pi is exactly
    k + 1/2 in float32 (k = 0, 1, 2: the ties rounding half to even
    breaks), with +-0 and a holed mask."""
    rng = np.random.default_rng(seed)
    tp = np.float32(2 * np.pi)
    ties = []
    for q in (0.5, 1.5, 2.5, -1.5, -2.5):
        y0 = np.array([np.float32(q) * tp], np.float32)
        cands = (y0.view(np.int32) + np.arange(-64, 65, dtype=np.int32)).view(np.float32)
        ties += list(cands[cands / tp == np.float32(q)][:1])
    assert len(ties) >= 3
    even = (np.add.outer(np.arange(H), np.arange(W)) % 2) == 0
    Phi = np.where(even, rng.choice(np.float32([0.0, -0.0]), size=(H, W)),
                   rng.choice(np.array(ties, np.float32), size=(H, W))).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (Phi, rng.random((H, W)) > 0.1)]


@pytest.mark.parametrize("case,iters", [
    ("215x299", 4), ("215x301", 8), ("64x1281", 4), ("offset1", 4), ("130x200", 1),
    ("130x200", 9), ("130x200", 17), ("ties", 4), ("large", 6)])
def test_vote_kernels_on_layouts_and_values(cuda, case, iters):
    """K4 (registers, lanes along a row, warp-edge columns through shared
    memory) and K3 against the plain sweep, bit for bit: rows not a multiple
    of 16 bytes, a map one float off alignment, 1, 9 and 17 sweeps (more
    than one K4 launch), float32 ties of the rounding with +-0, and
    |Phi| ~ 1e6."""
    if case == "ties":
        Phi_n, mask = _tie_map(cuda, 96, 200, 3)
    else:
        H, W = (130, 200) if case in ("offset1", "130x200", "large") else map(
            int, case.split("x"))
        _, Phi_n, _, mask, _ = _phase_map(cuda, H, W, 2, partial=True)
        if case == "large":
            Phi_n = Phi_n + torch.where(torch.arange(W, device=cuda) < W // 2, 1e6, -1e6)
        if case == "offset1":
            bufs = [torch.empty(H * W + 1, dtype=t.dtype, device=cuda) for t in (Phi_n, mask)]
            for b, t in zip(bufs, (Phi_n, mask)):
                b[1:] = t.reshape(-1)
            Phi_n, mask = (b[1:].view(H, W) for b in bufs)
            assert Phi_n.data_ptr() % 16 == 4
    q = torch.ones_like(Phi_n)
    plain = pu.spatial_quality_unwrap(Phi_n, q, mask, iters)
    n = us.quality_unwrap_tiled.launches
    k4 = us.quality_unwrap_tiled(Phi_n, q, mask, iters)
    assert us.quality_unwrap_tiled.launches - n == -(-iters // us.MAX_HALO)
    k3 = us.launch_vote_resident(Phi_n, mask, iters)
    torch.cuda.synchronize()
    for got in (k4, k3):
        assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
    assert not torch.equal(plain, Phi_n)


K3_HALO = cu_constant("unwrap", "K3_HALO")


@pytest.mark.parametrize("iters", [1, K3_HALO + 1, 17, 64])
@pytest.mark.parametrize("H,W", [(1024, 1024), (8192, 128), (800, 1280)])
def test_k3_matches_plain_version_on_maps_of_its_route(cuda, H, W, iters):
    """K3 (the map resident in registers, tiles trading their rings every
    K3_HALO sweeps) against the plain sweep, bit for bit, on the largest
    maps the route rule sends it (128x8192: the most tiles) and a 1280x800
    camera's, from 1 sweep to 64 (many exchanges)."""
    assert not us.takes_tiled(H, W)
    _, Phi_n, q, mask, _ = _phase_map(cuda, H, W, 3, partial=True)
    plain = pu.spatial_quality_unwrap(Phi_n, q, mask, iters)
    n = us.quality_unwrap.launches
    k3 = us.quality_unwrap(Phi_n, q, mask, iters)
    torch.cuda.synchronize()
    assert us.quality_unwrap.launches == n + 1
    assert torch.equal(k3.view(torch.int32), plain.view(torch.int32))
    assert not torch.equal(plain, Phi_n)


@pytest.mark.parametrize("iters", [1, K3_HALO + 1, 2 * K3_HALO, 3 * K3_HALO])
def test_k3_exchanges_tile_corners(cuda, iters):
    """Repairs that cross every corner of K3's tiles a sweep at a time: the
    tiles' corner halo cells, read from the diagonal tiles, bit for bit."""
    geometry = [cu_constant("unwrap", f"K3_{n}") for n in ("RUN", "WARPS", "HALO")]
    Phi_n, mask = (torch.from_numpy(a).to(cuda) for a in corner_fronts(800, 1280, *geometry))
    plain = pu.spatial_quality_unwrap(Phi_n, None, mask, iters)
    k3 = us.launch_vote_resident(Phi_n, mask, iters)
    torch.cuda.synchronize()
    assert torch.equal(k3.view(torch.int32), plain.view(torch.int32))


def test_k3_back_to_back_launches_are_equal(cuda):
    """20 launches with no sync between them: each launch's tiles see their
    own sweep counters (zeroed before each launch), so every output is the
    plain sweep's, signs of zeros included."""
    _, Phi_n, q, mask, _ = _phase_map(cuda, 800, 1280, 4, partial=True)
    outs = [us.launch_vote_resident(Phi_n, mask, 8) for _ in range(20)]
    plain = pu.spatial_quality_unwrap(Phi_n, q, mask, 8)
    torch.cuda.synchronize()
    assert all(torch.equal(o.view(torch.int32), plain.view(torch.int32)) for o in outs)


def test_k3_graphs_replayed_on_two_streams_are_independent(cuda):
    """Two CUDA graphs holding K3, on two maps, replayed at once on two
    streams, again and again: each launch owns its counters and rings, so
    each replay gives its map's plain sweep, bit for bit."""
    maps = [_phase_map(cuda, H, W, 6 + i, partial=True) for i, (H, W) in
            enumerate(((800, 1280), (1024, 1024)))]
    plains = [pu.spatial_quality_unwrap(Phi_n, q, mask, 9) for _, Phi_n, q, mask, _ in maps]
    streams = [torch.cuda.Stream() for _ in maps]
    graphs, outs = [], []
    for s, (_, Phi_n, _, mask, _) in zip(streams, maps):
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            us.launch_vote_resident(Phi_n, mask, 9)   # warm-up off the capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s):
            outs.append([us.launch_vote_resident(Phi_n, mask, 9) for _ in range(4)])
        graphs.append(graph)
    torch.cuda.synchronize()
    for _ in range(10):
        for s, graph in zip(streams, graphs):
            with torch.cuda.stream(s):
                graph.replay()
        torch.cuda.synchronize()
        for got, plain in zip(outs, plains):
            assert all(torch.equal(o.view(torch.int32), plain.view(torch.int32)) for o in got)


def test_k3_refuses_a_map_past_one_wave(cuda):
    """A 5 MP map needs more tiles than one wave of K3's blocks holds: the
    wrapper raises and names the limit, and nothing falls back."""
    _, Phi_n, _, mask, _ = _phase_map(cuda, 2048, 2448, 5)
    wave, _, ow, oh = us.resident_layout(cuda.index or 0)
    assert us.resident_tiles(2048, 2448, ow, oh) > wave
    n = us.quality_unwrap.launches
    with pytest.raises(ValueError, match=f"at most {wave} tiles"):
        us.launch_vote_resident(Phi_n, mask, 4)
    assert us.quality_unwrap.launches == n


def test_quality_unwrap_dispatch(cuda):
    """The reference's rule: a 1280x1024 map takes K4, a smaller one K3."""
    for (H, W), kernel in (((1024, 1280), "tiled"), ((215, 300), "resident")):
        _, Phi_n, q, mask, _ = _phase_map(cuda, H, W, 1)
        us.quality_unwrap.launches = us.quality_unwrap_tiled.launches = 0
        out = us.quality_unwrap(Phi_n, q, mask, iters=4)
        torch.cuda.synchronize()
        assert (us.quality_unwrap.launches, us.quality_unwrap_tiled.launches) == (
            (0, 1) if kernel == "tiled" else (1, 0))
        assert torch.equal(out, pu.spatial_quality_unwrap(Phi_n, q, mask, 4))


def test_quality_unwrap_past_one_wave_takes_k4(cuda):
    """A 32 x 32768 map is within the reference's 12 MiB budget, but its
    tiles exceed one wave of K3's blocks: ``quality_unwrap`` takes K4 and
    returns the plain sweep's bits, and K3 itself still refuses the map."""
    H, W = 32, 32768
    _, Phi_n, q, mask, _ = _phase_map(cuda, H, W, 9, partial=True)
    wave, _, ow, oh = us.resident_layout(cuda.index or 0)
    assert not us.takes_tiled(H, W) and us.resident_tiles(H, W, ow, oh) > wave
    us.quality_unwrap.launches = us.quality_unwrap_tiled.launches = 0
    out = us.quality_unwrap(Phi_n, q, mask, iters=8)
    torch.cuda.synchronize()
    assert (us.quality_unwrap.launches, us.quality_unwrap_tiled.launches) == (0, 1)
    plain = pu.spatial_quality_unwrap(Phi_n, q, mask, 8)
    assert torch.equal(out.view(torch.int32), plain.view(torch.int32))
    with pytest.raises(ValueError, match=f"at most {wave} tiles"):
        us.launch_vote_resident(Phi_n, mask, 8)


@pytest.mark.parametrize("H,W", [(37, 53), (256, 320), (215, 300)])
def test_wavefront_pass_matches_plain_version(cuda, H, W):
    rng = np.random.default_rng(H)
    Phi = np.cumsum(rng.normal(0.6, 0.8, size=(H, W)), axis=1).astype(np.float32)
    phi = np.mod(Phi, 2 * np.pi).astype(np.float32)
    done = rng.random((H, W)) < 0.02
    elig = rng.random((H, W)) < 0.85
    args = [torch.from_numpy(a).to(cuda) for a in
            (phi, elig, np.where(done, Phi, phi).astype(np.float32), done)]
    for axis in (1, 0):
        for reverse in (False, True):
            before = wf.wavefront_pass.launches
            Pk, dk = wf.wavefront_pass(*args, axis, reverse)
            assert wf.wavefront_pass.launches == before + 1
            Pp, dp = pu.directional_pass(*args, axis, reverse)
            torch.cuda.synchronize()
            assert dk.dtype == torch.bool and torch.equal(dk, dp)
            assert torch.equal(Pk, Pp)
            assert int(dk.sum()) > int(args[3].sum())


def _wave_maps(device, H, W, seed, offset=0):
    """(phi, elig, Phi, done) for one pass: 2 % done, 85 % eligible;
    ``offset``: each map starts that many elements into a larger buffer."""
    rng = np.random.default_rng(seed)
    Phi = np.cumsum(rng.normal(0.6, 0.8, size=(H, W)), axis=1).astype(np.float32)
    phi = np.mod(Phi, 2 * np.pi).astype(np.float32)
    done = rng.random((H, W)) < 0.02
    elig = rng.random((H, W)) < 0.85
    out = []
    for a in (phi, elig, np.where(done, Phi, phi).astype(np.float32), done):
        t = torch.from_numpy(a).to(device)
        buf = torch.empty(H * W + offset, dtype=t.dtype, device=device)
        buf[offset:] = t.reshape(-1)
        out.append(buf[offset:].view(H, W))
    return out


def test_wavefront_rounding_equals_the_division(cuda):
    """K5 rounds (x - ps) / 2pi by a reciprocal and one FMA correction; on
    every one of the 2^32 float32 inputs it gives the IEEE division's bits
    (the plain version's), and the voting kernels' rounding gives them but
    for the sign of a zero."""
    assert wf.cycles_mismatches(cuda) == (0, 0)


@pytest.mark.parametrize("H,W,offset", [
    (2048, 2448, 0), (215, 300, 0), (1037, 1283, 0), (9000, 40, 0), (3, 10240, 0),
    (64, 1280, 1)])
def test_wavefront_pass_bit_equal_on_every_layout(cuda, H, W, offset):
    """K5 equals the plain pass bit for bit on both axes and directions:
    columns of 2048 (4 a block) and 1037 (6 a block; not a multiple of 8 or
    16), columns of 9000 and rows of the longest line it takes (the
    16-element build), ragged rows, and rows whose maps are not 16-byte
    aligned."""
    args = _wave_maps(cuda, H, W, H + W, offset)
    for axis in (1, 0):
        for reverse in (False, True):
            Pk, dk = wf.launch_wavefront_pass(*args, axis, reverse)
            Pp, dp = pu.directional_pass(*args, axis, reverse)
            torch.cuda.synchronize()
            assert torch.equal(Pk, Pp) and torch.equal(dk, dp), (axis, reverse)
    with pytest.raises(ValueError, match="at most"):
        wf.launch_wavefront_pass(*_wave_maps(cuda, 2, wf.MAX_LINE + 1, 0), 1, False)


@pytest.mark.parametrize("H,W", [(96, 160), (215, 300)])
def test_wavefront_unwrap_and_repair_match_plain_version(cuda, H, W):
    """Repair (light defaults: 8 launches; 4 levels x 2 rounds: 32) and
    phase-only unwrap through K5 against the plain loop; the blob is
    repaired."""
    Phi, Phi_n, q, mask, _ = _phase_map(cuda, H, W, 3, blob=True)
    for levels, rounds in ((2, 1), (4, 2)):
        wf.wavefront_pass.launches = 0
        out = wf.wavefront_repair(Phi_n, q, mask, levels=levels, rounds_per_level=rounds)
        assert wf.wavefront_pass.launches == 4 * levels * rounds
        ref = pu.quality_guided_repair(Phi_n, q, mask, levels=levels, rounds_per_level=rounds)
        torch.cuda.synchronize()
        assert float((out - ref).abs().max()) <= 1e-3
        assert float((out - Phi).abs().max()) < 1e-3
    phi = torch.remainder(Phi_n, 2 * math.pi)
    out, reached = wf.wavefront_unwrap(phi, q, mask)
    ref, reached_ref = pu.quality_guided_unwrap(phi, q, mask)
    assert torch.equal(reached, reached_ref) and float(reached.float().mean()) > 0.99
    assert float((out - ref)[reached].abs().max()) <= 1e-3


def test_spatial_kernels_reject_bad_input(cuda):
    _, Phi_n, _, mask, _ = _phase_map(cuda, 32, 48, 0)
    with pytest.raises(ValueError, match="contiguous"):
        us.launch_vote_resident(Phi_n.t(), mask.t(), 2)
    with pytest.raises(ValueError, match="sweeps"):
        us.launch_vote_tiled(Phi_n, mask, us.MAX_HALO + 1)
    with pytest.raises(ValueError, match="one device"):
        wf.launch_wavefront_pass(Phi_n, mask[:16], Phi_n, mask, 1, False)
    with pytest.raises(ValueError, match="CUDA"):
        us.launch_vote_tiled(Phi_n.cpu(), mask.cpu(), 2)


@pytest.mark.parametrize("mode", ["voting", "wavefront"])
def test_dense_reconstructor_spatial_launches(cuda, mode):
    """K1 once, then K3 once (a 320x256 map is within the resident budget)
    or K5 eight times; the mask is the unrepaired one; the repaired set is
    the plain route's (the same function on the host)."""
    cam, proj = default_rig(cam_w=320, cam_h=256, proj_w=256, proj_h=192)
    cfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=6, phase_steps=4)
    gen = torch.Generator().manual_seed(9)
    scan = render_scan(cam, proj, bumps_depth(256, 320, base=480.0, amp=25.0), cfg,
                       noise_std=0.01, generator=gen)
    dec = DecodeConfig(spatial_unwrap_mode=mode)
    model = DenseReconstructor(cam, proj, cfg, dec, spatial_iters=4).to(cuda)
    base = DenseReconstructor(cam, proj, cfg).to(cuda)(scan.frames.to(cuda))
    counts = (fs.fused_decode_triangulate, us.quality_unwrap, us.quality_unwrap_tiled,
              wf.wavefront_pass)
    for fn in counts:
        fn.launches = 0
    cloud = model(scan.frames.to(cuda))
    torch.cuda.synchronize()
    assert [fn.launches for fn in counts] == (
        [1, 1, 0, 0] if mode == "voting" else [1, 0, 0, 8])
    assert torch.equal(cloud.mask, base.mask)
    fixed = (cloud.x_p - base.x_p).abs() > cfg.fringe_pitch / 2
    _, plain_fixed = spatial_repair(base.x_p.cpu(), base.quality.cpu(), base.mask.cpu(),
                                    cfg.fringe_pitch, 4, mode)
    assert torch.equal(fixed.cpu(), plain_fixed) and int(fixed.sum()) > 0
    valid = cloud.mask.cpu() & scan.mask_true
    err = torch.linalg.norm(cloud.points.cpu() - scan.points_true, dim=-1)[valid]
    assert float(err.square().mean().sqrt()) < 0.5


def _band_cloud(device, n_t, n_q, seed, dup=0):
    """A bumpy scan-sized surface (|q| ~ 500 mm) and noisy queries near it;
    ``dup`` targets repeated at once after the originals."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-120, 120, (n_t, 2))
    z = 500 + 20 * np.sin(xy[:, 0] / 25.0) * np.cos(xy[:, 1] / 30.0)
    tgt = np.column_stack([xy, z]).astype(np.float32)
    if dup:
        tgt = np.concatenate([tgt, tgt[rng.integers(0, n_t, dup)]])
    qry = (tgt[rng.integers(0, len(tgt), n_q)] + rng.normal(0, 1.5, (n_q, 3))
           ).astype(np.float32)
    nrm = rng.normal(size=tgt.shape).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (tgt, qry, nrm)]


def _sorted_queries(bt, qry):
    order = torch.sort(qry @ bt.axis, stable=True).indices
    return qry[order].T.contiguous()


def _brute_force(qc, tgt, valid):
    """Float64 distances of every (query, valid target) pair."""
    d = torch.cdist(qc.T.double(), tgt.double(),
                    compute_mode="donot_use_mm_for_euclid_dist") ** 2
    return torch.where(valid[None, :], d, float("inf"))


@pytest.mark.parametrize("case", ["ragged", "masked", "duplicates", "empty_band",
                                  "wider_than_cap"])
def test_band_kernel_matches_plain_version_and_brute_force(cuda, case):
    """K8 equals its plain version (the same d2 bits, points, normals,
    indices) and the brute force within r: a ragged query count (no
    multiple of the tile), 10 % of targets masked, duplicated targets (the
    lowest sorted position, i.e. original index, wins), a query tile with
    an empty band, and bands wider than the reference's cap."""
    r = 6.0
    tgt, qry, nrm = _band_cloud(cuda, 20000, 3001, 4, dup=3000 if case == "duplicates" else 0)
    valid = torch.ones(len(tgt), dtype=torch.bool, device=cuda)
    if case == "masked":
        valid = torch.from_numpy(np.random.default_rng(1).random(len(tgt)) > 0.1).to(cuda)
    bt = rb.build_band_target(tgt, nrm, valid)
    qc = _sorted_queries(bt, qry)
    qv = torch.ones(qc.shape[1], dtype=torch.bool, device=cuda)
    if case == "empty_band":    # a tile of far queries, and an invalid tile
        far = (bt.axis[:, None] * -1e4).expand(3, kb.QT)
        qc = torch.cat([far, qc, -far], dim=1).contiguous()
        qv = torch.ones(qc.shape[1], dtype=torch.bool, device=cuda)
        qv[-kb.QT:] = False
    jstart, jend = kb.tile_bands(bt.axis @ qc, qv, bt, r)
    widths = jend - jstart
    if case == "empty_band":
        assert int(widths[0]) <= 0 and int(widths[-1]) <= 0
    if case == "wider_than_cap":   # the reference's cap, measured at one end
        cap = rb.suggest_b_max(qc[:, :1].T.expand(200, 3), tgt, r)
        assert int(widths.max()) > cap
    before = rb.band_nn_sorted.launches
    k = rb.band_nn_sorted(qc, qv, bt, r, b_max=1)
    assert rb.band_nn_sorted.launches == before + 1
    p = kb.band_nn_sorted_reference(qc, qv, bt, r)
    torch.cuda.synchronize()
    assert torch.equal(k[3], p[3])
    hit = k[3] >= 0
    assert torch.equal(torch.isinf(k[0]), ~hit)
    assert torch.equal(k[0][hit], p[0][hit])
    assert torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])
    # against the brute force: every query with a valid target within r hits
    d = _brute_force(qc, tgt, valid)
    best, ref = d.min(dim=1)
    within = (best <= r * r) & qv
    border = (best - r * r).abs() <= 1e-3    # float32 rounding at r
    assert torch.equal(hit & ~border, within & ~border)
    got = d.gather(1, k[3].clamp(min=0)[:, None])[:, 0]
    assert bool(((got - best).abs() <= 1e-3)[hit].all())
    # the winner's point and normal are the target's, its index an original
    assert torch.equal(k[1][hit], tgt[k[3][hit]]) and torch.equal(k[2][hit], nrm[k[3][hit]])
    assert bool(valid[k[3][hit]].all())
    if case == "duplicates":    # a copy never wins over its original
        assert bool((k[3][hit] < 20000).all())
    if case == "empty_band":
        assert bool((k[3][:kb.QT] == -1).all()) and bool((k[3][-kb.QT:] == -1).all())
    assert int(hit.sum()) > 0.5 * int(qv.sum()) - 2 * kb.QT


def test_band_kernel_rejects_bad_input(cuda):
    tgt, qry, nrm = _band_cloud(cuda, 2000, 300, 0)
    bt = rb.build_band_target(tgt, nrm)
    qc = _sorted_queries(bt, qry)
    qv = torch.ones(qc.shape[1], dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kb.launch_band_nn(qc.T.contiguous().T, qv, bt, 5.0)
    with pytest.raises(ValueError, match="CUDA"):
        kb.launch_band_nn(qc.cpu(), qv.cpu(), bt, 5.0)
    with pytest.raises(ValueError):
        kb.launch_band_nn(qc, qv.to(torch.uint8), bt, 5.0)


def test_band_icp_launches_once_per_iteration_without_host_sync(cuda):
    """``nn_method="auto"`` above the crossover takes the band route on the
    card: one K8 launch per iteration, no host sync in the whole call, and
    the pose of the band ICP on the CPU (K8's plain version; "auto" takes
    the voxel hash there)."""
    rng = np.random.default_rng(13)
    n = 32768            # 32768^2 pairs > the 24000^2 crossover
    xy = rng.uniform(-150, 150, (n, 2))
    z = 500 + 20 * np.sin(xy[:, 0] / 25.0) * np.cos(xy[:, 1] / 30.0) + 8 * np.sin(xy[:, 1] / 12.0)
    src = np.column_stack([xy, z]).astype(np.float32)
    gx = 20 * np.cos(xy[:, 0] / 25.0) / 25.0 * np.cos(xy[:, 1] / 30.0)
    gy = (-20 * np.sin(xy[:, 0] / 25.0) * np.sin(xy[:, 1] / 30.0) / 30.0
          + 8 * np.cos(xy[:, 1] / 12.0) / 12.0)
    n0 = np.column_stack([-gx, -gy, np.ones_like(gx)])
    n0 /= np.linalg.norm(n0, axis=1, keepdims=True)
    ang = 0.01
    R_true = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                       [0, 0, 1]], np.float32)
    t_true = np.array([1.5, -1.0, 2.0], np.float32)
    tgt = (src @ R_true.T + t_true).astype(np.float32)
    n_tgt = (n0 @ R_true.T).astype(np.float32)
    args = [torch.from_numpy(a) for a in (src, tgt, n_tgt)]
    on_card = [a.to(cuda) for a in args]
    rb.band_nn_sorted.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = icp_point_to_plane(*on_card, iters=6, max_corr_dist=8.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert rb.band_nn_sorted.launches == 6
    ref = icp_point_to_plane(*args, iters=6, max_corr_dist=8.0, nn_method="band")
    np.testing.assert_allclose(res.R.cpu().numpy(), ref.R.numpy(), atol=1e-5)
    np.testing.assert_allclose(res.t.cpu().numpy(), ref.t.numpy(), atol=1e-3)
    np.testing.assert_allclose(res.R.cpu().numpy(), R_true, atol=1e-4)
    np.testing.assert_allclose(res.t.cpu().numpy(), t_true, atol=1e-2)


# ------------------------------------------------------------ K6 and K7

INTERP = (True, True, False, False)


def _crossing_case(device, R, U, seed, wiggle=0.0):
    """The reference's random crossing case (tests/test_twocam.py:316-322),
    with noise ``wiggle`` on the codes so that bins cross several times."""
    rng = np.random.default_rng(seed)
    code = np.cumsum(rng.uniform(0.2, 1.4, (R, U)), axis=1)
    code = code - code[:, :1] + rng.uniform(-3, 3, (R, 1))
    code = (code + wiggle * rng.normal(size=(R, U))).astype(np.float32)
    valid = rng.random((R, U)) > 0.05
    ch = (rng.normal(0, 1, (4, R, U)) * 10 + 50).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (code, valid, ch)]


def _crossing_agree(cnt, vals, cnt_p, vals_p):
    """Counts and values bit-equal: the plain versions sum each bin in the
    kernels' ascending pair order."""
    assert torch.equal(cnt, cnt_p) and torch.equal(vals, vals_p)


@pytest.mark.parametrize("R,U,K,wiggle", [(24, 700, 520, 0.0), (37, 333, 200, 0.5),
                                          (1024, 1280, 1024, 0.3), (7, 2, 9, 0.0)])
def test_crossing_kernels_match_plain_versions(cuda, R, U, K, wiggle):
    code, valid, ch = _crossing_case(cuda, R, U, R + U, wiggle)
    gates = ((1, 25.0),)
    before = (kx.crossing_interp_fused.launches, kx.crossing_bin_sum.launches)
    cnt, vals = kx.crossing_interp_fused(code, valid, ch, K, INTERP, gates=gates)
    gate = (ch[1][:, 1:] - ch[1][:, :-1]).abs() < 25.0
    cnt6, vals6 = kx.crossing_interp(code, valid, ch, K, INTERP, pair_gate=gate)
    assert (kx.crossing_interp_fused.launches, kx.crossing_bin_sum.launches) == (
        before[0] + 1, before[1] + 1)
    cnt_p, vals_p = kx.crossing_interp_fused_reference(code, valid, ch, K, INTERP, gates=gates)
    torch.cuda.synchronize()
    _crossing_agree(cnt, vals, cnt_p, vals_p)
    _crossing_agree(cnt6, vals6, cnt_p, vals_p)
    if wiggle:
        assert float(cnt_p.max()) >= 2.0
    # two launches give the same bits (no float atomics)
    again = kx.crossing_interp_fused(code, valid, ch, K, INTERP, gates=gates)
    assert torch.equal(again[0], cnt) and torch.equal(again[1], vals)


def test_bin_sum_kernel_matches_plain_version(cuda):
    rng = np.random.default_rng(7)
    R, U, N, K = 33, 411, 11, 300           # N > the kernel's channel group of 8
    lo = np.cumsum(rng.uniform(0.2, 1.6, (R, U)), axis=1).astype(np.float32) - 5.0
    hi = lo + rng.uniform(0.1, 2.4, (R, U)).astype(np.float32)
    dead = rng.random((R, U)) < 0.1
    lo[dead] = hi[dead] = -1.0
    pay = rng.normal(0, 3, (R, N, U)).astype(np.float32)
    pay[np.broadcast_to(dead[:, None, :], pay.shape)] = 0.0
    lo, hi, pay = (torch.from_numpy(a).to(cuda) for a in (lo, hi, pay))
    out = kx.crossing_bin_sum(lo, hi, pay, K)
    ref = kx.crossing_bin_sum_reference(lo, hi, pay, K)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def _adversarial(device, kind, seed=0):
    """The adversarial rows of tests/test_torch_crossing.py (code, valid,
    channels, K), or K6's wide spans (lo, hi, payload, K); plus R below the
    SM count and R far above the persistent grid."""
    rng = np.random.default_rng(seed)
    if kind == "span40":
        R, U, N, K = 9, 333, 5, 150
        lo = rng.uniform(-20, K + 5, (R, U)).astype(np.float32)
        hi = (lo + rng.uniform(30, 45, (R, U))).astype(np.float32)
        dead = rng.random((R, U)) < 0.1
        lo[dead] = hi[dead] = -1.0
        lo[0, :7] = [np.nan, -np.inf, 3.5, np.nan, -np.inf, 10.0, np.inf]
        hi[0, :7] = [5.0, 2.5, np.nan, np.nan, np.inf, np.inf, np.inf]
        pay = rng.normal(0, 3, (R, N, U)).astype(np.float32)
        pay[np.broadcast_to(dead[:, None, :], pay.shape)] = 0.0
        return [torch.from_numpy(a).to(device) for a in (lo, hi, pay)] + [K]
    R, U, K, wiggle, start = {"wiggle2": (12, 333, 260, 2.0, (-3, 3)),
                              "nan_inf": (9, 701, 520, 0.0, (-3, 3)),
                              "clipped": (10, 300, 120, 0.3, (-30, -5)),
                              "u700": (6, 700, 520, 0.5, (-3, 3)),
                              "rows_below_sms": (7, 1280, 1024, 0.3, (-3, 3)),
                              "rows_above_grid": (3000, 130, 110, 0.3, (-3, 3))}[kind]
    code = np.cumsum(rng.uniform(0.2, 1.4, (R, U)), axis=1)
    code = code - code[:, :1] + rng.uniform(*start, (R, 1))
    code = (code + wiggle * rng.normal(size=(R, U))).astype(np.float32)
    if kind == "nan_inf":
        for value, share in ((np.nan, 0.03), (np.inf, 0.01), (-np.inf, 0.01)):
            code[rng.random((R, U)) < share] = value
    valid = rng.random((R, U)) > 0.05
    ch = (rng.normal(0, 1, (4, R, U)) * 10 + 50).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (code, valid, ch)] + [K]


@pytest.mark.parametrize("kind", ["wiggle2", "nan_inf", "clipped", "u700", "rows_below_sms",
                                  "rows_above_grid"])
def test_crossing_kernels_match_plain_versions_on_adversarial_rows(cuda, kind):
    """K7, and K6 through crossing_interp, against the
    plain versions: long pair ranges, NaN and infinite codes, bins clipped
    at both ends, unaligned rows, few rows and many; two launches equal."""
    code, valid, ch, K = _adversarial(cuda, kind, seed=len(kind))
    gates = ((1, 25.0),)
    gate = kx.gate_mask(ch, gates)
    plain = kx.crossing_interp_fused_reference(code, valid, ch, K, INTERP, gates=gates)
    lo, hi, pay, unpack = kx.crossing_pairs(code, valid, ch, INTERP, pair_gate=gate)
    kgrid = torch.arange(K, dtype=torch.float32, device=cuda)[None, :]
    got = kx.crossing_interp_fused(code, valid, ch, K, INTERP, gates=gates)
    again = kx.crossing_interp_fused(code, valid, ch, K, INTERP, gates=gates)
    torch.cuda.synchronize()
    _crossing_agree(*got, *plain)
    _crossing_agree(*again, *got)
    cnt6, vals6 = unpack(kx.launch_bin_sum(lo, hi, pay, K), kgrid)
    torch.cuda.synchronize()
    _crossing_agree(cnt6, torch.stack(vals6), *plain)
    if kind == "wiggle2":
        assert float(plain[0].max()) >= 4.0


def test_bin_sum_kernel_on_wide_spans(cuda):
    """K6 on pairs spanning 30-45 bins, clipped at both ends, with NaN and
    infinite codes, against its plain version."""
    lo, hi, pay, K = _adversarial(cuda, "span40")
    ref = kx.crossing_bin_sum_reference(lo, hi, pay, K)
    n_fire = kx.crossing_bin_sum_reference(lo, hi, torch.ones_like(pay[:, :1]), K)
    out = kx.launch_bin_sum(lo, hi, pay, K)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert float(n_fire.max()) >= 20


def test_crossing_kernels_at_the_shared_memory_limit(cuda):
    """The widest rows a block holds (one row buffer, no prefetch) launch and
    equal their plain versions; one code wider, K7 refuses, and K6 takes the
    row in two chunks of pairs, with the same bits."""
    lib = kx.library()
    U = 2048
    while lib.slr_interp_fused_smem(U + 1, 4, U + 1) <= kx.SMEM_MAX:
        U += 1
    code, valid, ch = _crossing_case(cuda, 3, U, 5, 0.3)
    got = kx.crossing_interp_fused(code, valid, ch, U, INTERP, gates=((1, 25.0),))
    plain = kx.crossing_interp_fused_reference(code, valid, ch, U, INTERP, gates=((1, 25.0),))
    torch.cuda.synchronize()
    _crossing_agree(*got, *plain)
    wide = torch.cat([code, code[:, -1:] + 1.0], dim=1)
    with pytest.raises(ValueError, match="shared memory"):
        kx.launch_interp_fused(wide, torch.ones_like(wide, dtype=torch.bool),
                               torch.cat([ch, ch[:, :, -1:]], dim=2), U + 1, INTERP)
    Up = 2048
    while lib.slr_bin_sum_smem(Up + 1, 1024) <= kx.SMEM_MAX:
        Up += 1
    assert kx.bin_sum_chunk(1024) == Up
    for U6, launches in ((Up + 1, 1), (Up + 2, 2)):
        lo, hi, pay, _ = kx.crossing_pairs(*_crossing_case(cuda, 5, U6, 6, 0.3)[:3], INTERP)
        n = kx.crossing_bin_sum.launches
        out = kx.launch_bin_sum(lo, hi, pay, 1024)
        ref = kx.crossing_bin_sum_reference(lo, hi, pay, 1024)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
        assert kx.crossing_bin_sum.launches - n == launches


def test_bin_sum_kernel_in_chunks_of_pairs(cuda):
    """Rows of 40,000 pairs exceed one K6 block at 1,024 bins: K6 runs over
    chunks of pairs in order, each continuing the previous chunk's sums, and
    equals the plain version bit for bit (one ascending add chain a bin)."""
    R, U, N, K = 4, 40_000, 7, 1024
    lo, hi, pay = long_range_pairs(cuda, R, U, N, K)
    chunk = kx.bin_sum_chunk(K)
    assert chunk < U
    n = kx.crossing_bin_sum.launches
    out = kx.crossing_bin_sum(lo, hi, pay, K)
    ref = kx.crossing_bin_sum_reference(lo, hi, pay, K)
    torch.cuda.synchronize()
    assert kx.crossing_bin_sum.launches - n == -(-U // chunk)
    assert torch.equal(out, ref)
    fires = kx.crossing_bin_sum_reference(lo, hi, torch.ones_like(pay[:, :1]), K)
    assert float(fires.max()) >= 20


@pytest.mark.parametrize("C,interp,gates,U", [
    (3, (True, False, True), ((2, 25.0),), 517),
    (4, (False, True, True, False), ((0, 30.0), (3, 30.0)), 701),
    (1, (False,), (), 333)])
def test_fused_kernel_on_other_channel_layouts(cuda, C, interp, gates, U):
    """Layouts other than the merge's take K7's general build: bit-equal to
    the plain version, and K6 through crossing_interp equal to both."""
    code, valid, ch = _crossing_case(cuda, 21, U, C + U, 0.5)
    ch = ch[:C].contiguous()
    got = kx.crossing_interp_fused(code, valid, ch, 400, interp, gates=gates)
    plain = kx.crossing_interp_fused_reference(code, valid, ch, 400, interp, gates=gates)
    got6 = kx.crossing_interp(code, valid, ch, 400, interp, pair_gate=kx.gate_mask(ch, gates))
    torch.cuda.synchronize()
    _crossing_agree(*got, *plain)
    _crossing_agree(*got6, *plain)
    assert float(plain[0].max()) >= 2.0
    grid, per_sm = kx.launch_shape("K7", 21, U, C, 400, interp)
    assert grid == 21 and per_sm >= 1


def test_crossing_kernels_reject_bad_input(cuda):
    code, valid, ch = _crossing_case(cuda, 16, 64, 1)
    with pytest.raises(ValueError, match="contiguous"):
        kx.launch_interp_fused(code.T.contiguous().T, valid, ch, 50, INTERP)
    with pytest.raises(ValueError, match="contiguous"):
        kx.launch_interp_fused(code, valid.T.contiguous().T, ch, 50, INTERP)
    with pytest.raises(ValueError):
        kx.launch_interp_fused(code, valid.to(torch.uint8), ch, 50, INTERP)
    with pytest.raises(ValueError, match="shared memory"):
        wide = torch.zeros((2, 20000), device=cuda)
        kx.launch_interp_fused(wide, wide > 0, torch.zeros((4, 2, 20000), device=cuda),
                               50, INTERP)
    with pytest.raises(ValueError, match="CUDA"):
        kx.launch_bin_sum(code.cpu(), code.cpu(), ch.cpu()[None, :, 0], 50)


def _two_camera(device, W, H, dtype=torch.float32):
    cfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=5, row_gray_bits=5,
                        phase_steps=3, row_phase_steps=3)
    c1, c2, proj = two_camera_rig(cam_w=W, cam_h=H, proj_w=256, proj_h=192, device=device)
    frames = []
    for i, c in enumerate((c1, c2)):
        gen = torch.Generator(device=device).manual_seed(i)
        f = render_scan(c, proj, spheres_scene(c, H, W), cfg, noise_std=0.003,
                        generator=gen, cast_shadows=True).frames
        frames.append(quantize_frames(f) if dtype == torch.uint8 else f)
    return cfg, c1, c2, frames


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_merge_launches_k1_twice_and_k7_four_times(cuda, dtype):
    """The merge on the card: K1's decode_only route for each camera and K7
    for both passes of both; the plain route agrees, and two calls give the
    same bits."""
    cfg, c1, c2, (f1, f2) = _two_camera(cuda, 320, 256, dtype)
    counts = [fs.fused_decode_triangulate, kx.crossing_interp_fused, kx.crossing_bin_sum]
    before = [w.launches for w in counts]
    a = reconstruct_two_camera(f1, f2, c1, c2, cfg)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(counts, before)] == [2, 4, 0]
    b = reconstruct_two_camera(f1, f2, c1, c2, cfg)
    assert torch.equal(a.points, b.points) and torch.equal(a.mask, b.mask)
    p = reconstruct_two_camera(f1, f2, c1, c2, cfg, merge_kernel=False)
    torch.cuda.synchronize()
    assert float((a.mask == p.mask).float().mean()) >= 0.9999
    both = a.mask & p.mask
    assert float(both.float().mean()) > 0.3
    assert float(torch.linalg.norm(a.points - p.points, dim=-1)[both].max()) <= 1e-3


def test_tiled_route_launches_k6(cuda, monkeypatch):
    """Past the route rule each pass goes to K6 through crossing_interp."""
    from slr_torch.pipeline import twocam

    monkeypatch.setattr(twocam, "FUSED_BUDGET", 0)
    cfg, c1, c2, (f1, f2) = _two_camera(cuda, 320, 256)
    before = (kx.crossing_interp_fused.launches, kx.crossing_bin_sum.launches)
    a = reconstruct_two_camera(f1, f2, c1, c2, cfg)
    torch.cuda.synchronize()
    assert (kx.crossing_interp_fused.launches - before[0],
            kx.crossing_bin_sum.launches - before[1]) == (0, 4)
    monkeypatch.setattr(twocam, "FUSED_BUDGET", 8 * 2 ** 20)
    b = reconstruct_two_camera(f1, f2, c1, c2, cfg)
    assert torch.equal(a.mask, b.mask)
    assert float(torch.linalg.norm(a.points - b.points, dim=-1)[a.mask].max()) <= 1e-3


def test_lm_solve_reads_nothing_on_the_host(cuda):
    """The masked LM loop: every step on the card, no host synchronisation
    in the whole solve (torch's sync debug mode raises on one)."""
    from slr_torch.calib import lm_solve

    t = torch.linspace(0, 2, 40, device=cuda)
    y = 2.0 * torch.exp(-1.3 * t) + 0.5

    def residual(x, t, y):
        return x[0] * torch.exp(x[1] * t) + x[2] - y

    x0 = torch.tensor([1.0, -0.5, 0.0], device=cuda)
    residual(x0, t, y)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x, cost = lm_solve(residual, x0, args=(t, y), iters=30, tol=1e-6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(cost) < 1e-8 and abs(float(x[1]) + 1.3) < 1e-3


def test_lm_solve_graph_replay_equals_eager_loop(cuda, monkeypatch):
    """On the card the LM step is replayed from a CUDA graph: the same bits
    and step count as the eager masked loop on the same inputs (chip_smoke.py's
    24-view stereo case, 168 parameters)."""
    from chip_smoke import calib_v24_case
    from slr_torch import calib as cal
    from slr_torch.calib import lm

    obj, cam_uv, proj_uv, _ = calib_v24_case(cuda)
    rc, rp = cal.calibrate_camera(obj, cam_uv), cal.calibrate_camera(obj, proj_uv)
    replayed = cal.stereo_calibrate(obj, cam_uv, proj_uv, rc, rp)
    steps = int(lm.lm_solve.steps)

    def eager(step, state, iters):
        for _ in range(iters):
            state = step(state)
        return state

    monkeypatch.setattr(lm, "_replayed", eager)
    loop = cal.stereo_calibrate(obj, cam_uv, proj_uv, rc, rp)
    assert int(lm.lm_solve.steps) == steps == 80
    assert torch.equal(replayed.rvecs, loop.rvecs) and torch.equal(replayed.rms, loop.rms)
    assert all(torch.equal(a, b) for a, b in zip(replayed.proj, loop.proj))


def test_calibration_on_card_matches_cpu(cuda):
    """chip_smoke.py's 24-view case on the card against the CPU: intrinsics
    within 1e-4 relative, RMS within 1e-4 px, the relative pose within
    1e-3 (float32 in other summation orders); two calls give the same
    bits."""
    from chip_smoke import calib_v24_case, same_bits
    from slr_torch import calib as cal

    obj, cam_uv, proj_uv, _ = calib_v24_case(cuda)
    runs = {}
    for where in ("cpu", cuda):
        o, c, p = (x.to(where) for x in (obj, cam_uv, proj_uv))
        rc, rp = cal.calibrate_camera(o, c), cal.calibrate_camera(o, p)
        runs[str(where)] = (rc, cal.stereo_calibrate(o, c, p, rc, rp))
    (rc, st), (rc_cpu, st_cpu) = runs[str(cuda)], runs["cpu"]
    for a, b in ((rc.camera, rc_cpu.camera), (st.cam, st_cpu.cam), (st.proj, st_cpu.proj)):
        for f in ("fx", "fy", "cx", "cy"):
            assert abs(float(getattr(a, f)) / float(getattr(b, f)) - 1) < 1e-4
    assert abs(float(st.rms) - float(st_cpu.rms)) < 1e-4
    assert float((st.proj.R.cpu() - st_cpu.proj.R).abs().max()) < 1e-3
    assert float((st.proj.t.cpu() - st_cpu.proj.t).abs().max()) < 1e-1
    assert same_bits(rc, cal.calibrate_camera(obj, cam_uv))


def test_detect_chessboard_on_card_matches_cpu(cuda):
    """A rendered 640x512 board: the card's corners within 0.01 px of the
    CPU's, by the device ordering, the same bits in two calls; projector
    corners likewise within 0.01 projector px."""
    from slr_torch import calib as cal
    from slr_torch.calib import corners
    from slr_torch.codec import decode_stack
    from slr_torch.synth.board import board_poses, render_board_view

    cam, proj = default_rig(cam_w=640, cam_h=512, proj_w=512, proj_h=384)
    cfg = PatternConfig(proj_width=512, proj_height=384, gray_bits=6, row_gray_bits=5,
                        phase_steps=4, row_phase_steps=4)
    R, t = board_poses(1, 9, 6, 20.0, seed=2)[0]
    bv = render_board_view(cam, proj, cfg, R, t, 9, 6, 20.0, 512, 640, noise_std=0.003,
                           generator=torch.Generator().manual_seed(0))
    n = corners.detect_chessboard.device_views
    got = [corners.detect_chessboard(bv.white_image.to(cuda), 9, 6)[0] for _ in range(2)]
    want = corners.detect_chessboard(bv.white_image, 9, 6)[0]
    assert corners.detect_chessboard.device_views == n + 3
    assert torch.equal(got[0], got[1])
    assert float((got[0].cpu() - want).abs().max()) < 0.01
    outs = []
    for where, c in ((cuda, got[0]), ("cpu", want)):
        res = decode_stack(bv.scan.frames.to(where), cfg, DecodeConfig())
        outs.append(cal.projector_corners_from_decode(res.x_p, res.y_p, res.mask,
                                                      res.quality, c))
    assert bool(outs[0][1].all()) and bool(outs[1][1].all())
    assert float((outs[0][0].cpu() - outs[1][0]).abs().max()) < 0.01


@pytest.mark.parametrize("capacity", [1 << 16, 3000])
def test_voxel_downsample_on_card_equals_cpu(cuda, capacity):
    """Config 5's voxel merge on the card: the same slots and flags as on
    the CPU, means within 1e-5 relative (each voxel summed in index order
    on both), and the same bits in two calls (no float atomics); also with
    voxels past ``capacity`` and a tail of more than one discarded
    segment."""
    from slr_torch.registration.voxel import voxel_downsample

    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.normal(500.0, 40.0, (200_000, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.random(200_000) > 0.3)
    col = torch.from_numpy(rng.random((200_000, 1)).astype(np.float32))
    cpu = voxel_downsample(pts, valid, 2.0, capacity, attrs=col)
    a = voxel_downsample(pts.to(cuda), valid.to(cuda), 2.0, capacity, attrs=col.to(cuda))
    b = voxel_downsample(pts.to(cuda), valid.to(cuda), 2.0, capacity, attrs=col.to(cuda))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(a[3]) == int(cpu[3]) and torch.equal(a[1].cpu(), cpu[1])
    torch.testing.assert_close(a[0].cpu(), cpu[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(a[2].cpu(), cpu[2], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- product


def _cloud_agrees_plain(k, p):
    """A cloud from K1 against the same call through its plain version
    (``test_kernel_matches_plain_version``'s tolerances)."""
    mk, mp = k.mask.cpu(), p.mask.cpu()
    assert float((mk ^ mp).float().mean()) <= 1e-3
    both = mk & mp
    assert float(both.float().mean()) > 0.3
    dx = (k.x_p.cpu() - p.x_p.cpu()).abs()
    assert float((both & (dx > 1e-3)).sum()) <= 1e-4 * float(both.sum())
    agree = both & (dx <= 1e-3)
    assert float((k.points.cpu() - p.points.cpu()).abs().amax(-1)[agree].max()) <= 1e-2
    assert float((k.quality.cpu() - p.quality.cpu()).abs().max()) <= 1e-5


@pytest.mark.parametrize("prefetch", [1, 2, 3])
def test_stream_side_stream_copy_gives_sequential_bits(cuda, prefetch):
    from slr_torch.pipeline import reconstruct_stream
    from slr_torch.pipeline.reconstruct import reconstruct_dense

    cam, proj, cfg, _ = _scan(torch.device("cpu"), 320, 256, 0.0)
    stacks = [quantize_frames(_scan(torch.device("cpu"), 320, 256, 0.004 * (k + 1))[3].frames)
              for k in range(4)]
    stacks[1] = stacks[1].numpy()            # numpy in, pageable
    stacks[2] = stacks[2].pin_memory()       # already pinned
    fs.fused_decode_triangulate.launches = 0
    got = [tuple(x.clone() for x in c) for c in reconstruct_stream(
        iter(stacks), cam, proj, cfg, prefetch=prefetch)]
    torch.cuda.synchronize()
    assert fs.fused_decode_triangulate.launches == 4
    cam_d, proj_d = cam.to(cuda), proj.to(cuda)
    for s, c in zip(stacks, got):
        ref = reconstruct_dense(torch.as_tensor(s).to(cuda), cam_d, proj_d, cfg)
        for a, b in zip(c, ref):
            assert torch.equal(a, b)


def test_nan_guard_on_card_tensors(cuda):
    from slr_torch.pipeline import nan_guard
    from slr_torch.pipeline.reconstruct import reconstruct_dense

    cam, proj, cfg, scan = _scan(cuda, 320, 256, 0.0)
    x = torch.tensor([-1.0, 4.0], device=cuda)
    with nan_guard():
        with pytest.raises(FloatingPointError):
            torch.log(x)
        assert float(torch.sqrt(x[1:])) == 2.0
        # K1 launches through ctypes: the guard sees no torch op in it
        cloud = reconstruct_dense(scan.frames, cam, proj, cfg)
    assert bool(torch.isnan(torch.log(x))[0]) and cloud.mask.any()


@pytest.mark.parametrize("route", ["fused", "uint8", "voting", "wavefront", "hdr", "scan",
                                   "accumulate"])
def test_session_on_the_card_matches_the_cpu(cuda, tmp_path, route):
    """One session directory reconstructed on the card and on the CPU: the
    kernels' float32 tolerances against their plain versions; every stage
    file the card writes loads back to the returned bits."""
    from slr_torch.config import ScanConfig
    from slr_torch.pipeline import Session

    if route == "hdr":
        cam, proj, cfg, _, frames = _bracket(torch.device("cpu"))
    else:
        cam, proj, cfg, scan = _scan(torch.device("cpu"), 320, 256, 0.004)
        frames = quantize_frames(scan.frames) if route == "uint8" else scan.frames
    dec = DecodeConfig(spatial_unwrap_mode="wavefront" if route == "wavefront" else "voting")
    kw = {"voting": dict(spatial_iters=4), "wavefront": dict(spatial_iters=4),
          "scan": dict(fused=False), "accumulate": dict(accumulate=True)}.get(route, {})
    root = tmp_path / "s"
    Session(root, ScanConfig(pattern=cfg, decode=dec), device="cpu").set_calibration(cam, proj)
    Session(root, device="cpu").add_scan(frames)
    c_cpu = Session(root, device="cpu").reconstruct(0, **kw)
    on_card = Session(root, device=cuda)
    fs.fused_decode_triangulate.launches = fs.fused_decode_triangulate_hdr.launches = 0
    c_gpu = on_card.reconstruct(0, **kw)
    torch.cuda.synchronize()
    assert c_gpu.points.device.type == "cuda"
    launched = (fs.fused_decode_triangulate.launches, fs.fused_decode_triangulate_hdr.launches)
    assert launched == {"hdr": (0, 1), "scan": (0, 0)}.get(route, (1, 0))
    _cloud_agrees_plain(c_gpu, c_cpu)
    for a, b in zip(on_card.load_cloud(0), c_gpu):
        assert torch.equal(a, b)
