"""The port's CUDA kernels (K1, every branch, K2, the spatial repair's K3, K4
and K5, the band search K8, the crossing kernels K6 and K7 of the
two-camera merge, the pose graph and the ICP) against their plain PyTorch
versions, on the card; and
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

from chip_smoke import (ICP_EDGE_TOL, ICP_TOL, POSE_GRAPH_CASES, box_exposures,
                        corner_fronts, cu_constant, hdr_best_exposure, icp_agreement,
                        icp_case, icp_grid_case, k2_box,
                        long_range_pairs, pose_graph_agreement, pose_graph_case,
                        pose_graph_edges, render_orbit)
from slr_torch import observability as obs
from slr_torch.codec import unwrap as pu
from slr_torch.config import DecodeConfig, PatternConfig, ReconstructConfig
from slr_torch.geom.camera import make_camera
from slr_torch.kernels import band_nn as kb
from slr_torch.kernels import crossing as kx
from slr_torch.kernels import fused_scan as fs
from slr_torch.kernels import icp as kicp
from slr_torch.kernels import pose_graph as kpg
from slr_torch.kernels import unwrap_scan as us
from slr_torch.kernels import wavefront as wf
from slr_torch.pipeline.reconstruct import (
    DenseReconstructor, accumulate_by_projector, spatial_repair)
from slr_torch.pipeline.twocam import reconstruct_two_camera
from slr_torch.registration import band as rb
from slr_torch.registration import posegraph as pg
from slr_torch.registration import projective as rp
from slr_torch.registration.icp import (ICPResult, _resolve_nn_method, icp_point_to_plane,
                                        icp_point_to_plane_reference)
from slr_torch.synth.render import (
    default_rig, quantize_frames, render_scan, two_camera_rig)
from slr_torch.synth.scene import bumps_depth, checker_albedo, spheres_scene

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


def launches(*kernels):
    """The launches so far of each kernel ("k1" .. "k8"), from the
    recorder's ``launches.*`` counters; of one kernel, a number."""
    counts = obs.snapshot().counts
    got = tuple(counts.get(f"launches.{k}", 0) for k in kernels)
    return got[0] if len(got) == 1 else got


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
    before = launches("k1")
    k = fs.fused_decode_triangulate(scan.frames, cam, proj, cfg, dec)
    assert launches("k1") == before + 1
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
    n = launches("k1")
    cloud = model(frames)
    torch.cuda.synchronize()
    assert launches("k1") - n == 1
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
    before = launches("k1")
    k = fs.fused_decode_triangulate(frames, cam, proj, cfg, dec, **kw)
    assert launches("k1") == before + 1
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
    before = launches("k1")
    k = fs.fused_decode_triangulate(frames, cam, proj, cfg, dec, **kw)
    assert launches("k1") == before + 1
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
    before = launches("k2")
    k = fs.fused_decode_triangulate_hdr(bracket, cam, proj, cfg, dec, fuse=fuse)
    assert launches("k2") == before + 1
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
        before = launches("k2")
        k = fs.fused_decode_triangulate_hdr(bracket, cam, proj, cfg, dec, fuse=fuse, **kw)
        assert launches("k2") == before + 1
        p = fs.fused_decode_triangulate_hdr_reference(bracket, cam, proj, cfg, dec, fuse=fuse,
                                                      **kw)
        torch.cuda.synchronize()
        _agrees(k, p, rows=False)


def test_dense_reconstructor_launches_once_on_uint8_and_bracket(cuda):
    cam, proj, cfg, scan, bracket = _bracket(torch.device("cpu"))
    model = DenseReconstructor(cam, proj, cfg).to(cuda)
    # the unit-gain exposure alone (no saturated cells), then the bracket
    for frames, k1, k2 in ((bracket[0], 1, 0), (bracket, 0, 1)):
        n1, n2 = launches("k1", "k2")
        cloud = model(frames.to(cuda))
        torch.cuda.synchronize()
        assert (launches("k1") - n1, launches("k2") - n2) == (k1, k2)
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
    before = (launches("k3"), launches("k4"))
    k3 = us.launch_vote_resident(Phi_n, mask, iters)
    assert launches("k3") == before[0] + 1
    for tile_h, halo in ((64, None), (16, 5), (128, 8)):
        n = launches("k4")
        k4 = us.quality_unwrap_tiled(Phi_n, q, mask, iters, tile_h=tile_h, halo=halo)
        chunk = halo or min(iters, us.MAX_HALO)
        assert launches("k4") - n == -(-iters // chunk)
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
    n = launches("k4")
    k4 = us.quality_unwrap_tiled(Phi_n, q, mask, iters)
    assert launches("k4") - n == -(-iters // us.MAX_HALO)
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
    n = launches("k3")
    k3 = us.quality_unwrap(Phi_n, q, mask, iters)
    torch.cuda.synchronize()
    assert launches("k3") == n + 1
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
    n = launches("k3")
    with pytest.raises(ValueError, match=f"at most {wave} tiles"):
        us.launch_vote_resident(Phi_n, mask, 4)
    assert launches("k3") == n


def test_quality_unwrap_dispatch(cuda):
    """The reference's rule: a 1280x1024 map takes K4, a smaller one K3."""
    for (H, W), kernel in (((1024, 1280), "tiled"), ((215, 300), "resident")):
        _, Phi_n, q, mask, _ = _phase_map(cuda, H, W, 1)
        n3, n4 = launches("k3", "k4")
        out = us.quality_unwrap(Phi_n, q, mask, iters=4)
        torch.cuda.synchronize()
        assert (launches("k3") - n3, launches("k4") - n4) == (
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
    n3, n4 = launches("k3", "k4")
    out = us.quality_unwrap(Phi_n, q, mask, iters=8)
    torch.cuda.synchronize()
    assert (launches("k3") - n3, launches("k4") - n4) == (0, 1)
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
            before = launches("k5")
            Pk, dk = wf.wavefront_pass(*args, axis, reverse)
            assert launches("k5") == before + 1
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
        n = launches("k5")
        out = wf.wavefront_repair(Phi_n, q, mask, levels=levels, rounds_per_level=rounds)
        assert launches("k5") - n == 4 * levels * rounds
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
    kernels = ("k1", "k3", "k4", "k5")
    before = launches(*kernels)
    cloud = model(scan.frames.to(cuda))
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(launches(*kernels), before)] == (
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
    before = launches("k8")
    k = rb.band_nn_sorted(qc, qv, bt, r, b_max=1)
    assert launches("k8") == before + 1
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
    n = launches("k8")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = icp_point_to_plane(*on_card, iters=6, max_corr_dist=8.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert launches("k8") - n == 6
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
    before = (launches("k7"), launches("k6"))
    cnt, vals = kx.crossing_interp_fused(code, valid, ch, K, INTERP, gates=gates)
    gate = (ch[1][:, 1:] - ch[1][:, :-1]).abs() < 25.0
    cnt6, vals6 = kx.crossing_interp(code, valid, ch, K, INTERP, pair_gate=gate)
    assert (launches("k7"), launches("k6")) == (
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
    for U6, chunks in ((Up + 1, 1), (Up + 2, 2)):
        lo, hi, pay, _ = kx.crossing_pairs(*_crossing_case(cuda, 5, U6, 6, 0.3)[:3], INTERP)
        n = launches("k6")
        out = kx.launch_bin_sum(lo, hi, pay, 1024)
        ref = kx.crossing_bin_sum_reference(lo, hi, pay, 1024)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
        assert launches("k6") - n == chunks


def test_bin_sum_kernel_in_chunks_of_pairs(cuda):
    """Rows of 40,000 pairs exceed one K6 block at 1,024 bins: K6 runs over
    chunks of pairs in order, each continuing the previous chunk's sums, and
    equals the plain version bit for bit (one ascending add chain a bin)."""
    R, U, N, K = 4, 40_000, 7, 1024
    lo, hi, pay = long_range_pairs(cuda, R, U, N, K)
    chunk = kx.bin_sum_chunk(K)
    assert chunk < U
    n = launches("k6")
    out = kx.crossing_bin_sum(lo, hi, pay, K)
    ref = kx.crossing_bin_sum_reference(lo, hi, pay, K)
    torch.cuda.synchronize()
    assert launches("k6") - n == -(-U // chunk)
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
    kernels = ("k1", "k7", "k6")
    before = launches(*kernels)
    a = reconstruct_two_camera(f1, f2, c1, c2, cfg)
    torch.cuda.synchronize()
    assert [x - b for x, b in zip(launches(*kernels), before)] == [2, 4, 0]
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
    before = (launches("k7"), launches("k6"))
    a = reconstruct_two_camera(f1, f2, c1, c2, cfg)
    torch.cuda.synchronize()
    assert (launches("k7") - before[0],
            launches("k6") - before[1]) == (0, 4)
    monkeypatch.setattr(twocam, "FUSED_BUDGET", 8 * 2 ** 20)
    b = reconstruct_two_camera(f1, f2, c1, c2, cfg)
    assert torch.equal(a.mask, b.mask)
    assert float(torch.linalg.norm(a.points - b.points, dim=-1)[a.mask].max()) <= 1e-3


def test_5mp_merge_takes_k6_and_waits_only_in_its_waits(cuda, monkeypatch):
    """A 2448x2048 uint8 pair (the benchmark's twocam_2448x2048: 1024x768
    projector, 7 + 6 Gray bits, 4-step phase on both axes) through the
    merge's normal path: K1 twice, K6 four times, no K7; one ``scan`` root
    whose decodes hold K1's parameter block and its one read; the payload
    counted from the shapes; and no host sync outside the ``wait`` spans
    (torch's sync debug mode raises on one)."""
    W, H = 2448, 2048
    cfg = PatternConfig(proj_width=1024, proj_height=768, gray_bits=7, row_gray_bits=6,
                        phase_steps=4, row_phase_steps=4)
    c1, c2, proj = two_camera_rig(cam_w=W, cam_h=H, device=cuda)
    frames = []
    for i, c in enumerate((c1, c2)):
        gen = torch.Generator(device=cuda).manual_seed(i)
        frames.append(quantize_frames(render_scan(
            c, proj, spheres_scene(c, H, W), cfg, noise_std=0.003, generator=gen,
            cast_shadows=True).frames))
    rec = ReconstructConfig(min_depth=300.0, max_depth=900.0)
    reconstruct_two_camera(*frames, c1, c2, cfg, rec=rec)          # builds and loads
    torch.cuda.synchronize()

    def unguarded(self):
        torch.cuda.set_sync_debug_mode("default")
        return obs.span.__enter__(self)

    def guarded(self, *exc):
        torch.cuda.set_sync_debug_mode("error")
        return obs.span.__exit__(self, *exc)

    monkeypatch.setattr(obs.wait, "__enter__", unguarded)
    monkeypatch.setattr(obs.wait, "__exit__", guarded)
    before = launches("k1", "k6", "k7")
    payload = obs.snapshot().counts.get("bytes.crossing_payload", 0)
    mark = max(s.id for s in obs.snapshot().spans)
    torch.cuda.set_sync_debug_mode("error")
    try:
        cloud = reconstruct_two_camera(*frames, c1, c2, cfg, rec=rec)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert [x - b for x, b in zip(launches("k1", "k6", "k7"), before)] == [2, 4, 0]
    assert int(cloud.mask.sum()) >= 560_000
    spans = sorted((s for s in obs.snapshot().spans if s.id > mark), key=lambda s: s.id)
    root = [s for s in spans if s.parent == 0]
    assert [s.name for s in root] == ["scan"]
    names = {s.id: s.name for s in spans}
    assert [s.name for s in spans if s.parent == root[0].id] == [
        "merge.decode", "merge.decode", "merge.edges", "merge.invert", "merge.invert",
        "merge.midpoint"]
    assert [(s.name, names[s.parent]) for s in spans if s.wait] == [
        ("params.read", "k1.params")] * 2
    assert [s.name for s in spans].count("crossing.k6") == 4
    assert obs.snapshot().counts["bytes.crossing_payload"] - payload == \
        2 * 4 * 9 * (H * (W - 1) + 1024 * (H - 1))


def test_hdr_stream_takes_k2_and_waits_only_in_its_waits(cuda, monkeypatch):
    """Two 1280x1024 three-exposure uint8 brackets (the benchmark's
    scan_c3_hdr3_u8: config 3's rig and patterns, an 8-cell 0.035 / 0.75
    checkerboard, gains 1, 3.2 and 10, noise 0.003 a capture) from pinned
    memory through ``reconstruct_stream``: K2 once a scan and no K1; one
    ``scan`` root a bracket holding ``hdr.colors``, K2's parameter block
    with its one read, and K2's launch; no host sync outside the ``wait``
    spans (torch's sync debug mode raises on one); each cloud within K2's
    plain version's tolerances, its colours the float formula's bits, as
    are the colours of every uint8 and uint16 count."""
    from slr_torch.pipeline import reconstruct_stream
    from slr_torch.pipeline import reconstruct as trec

    W, H = 1280, 1024
    cfg = PatternConfig(proj_width=1024, proj_height=768, gray_bits=7, phase_steps=4)
    cam, proj = default_rig(cam_w=W, cam_h=H, device=cuda)
    scan = render_scan(cam, proj, bumps_depth(H, W, base=480.0, amp=30.0, device=cuda), cfg,
                       albedo=checker_albedo(H, W, cells=8, lo=0.035, hi=0.75, device=cuda))
    gen = torch.Generator(device=cuda).manual_seed(9)
    brackets = [torch.stack([quantize_frames(torch.clamp(
        scan.frames * g + 0.003 * torch.randn(scan.frames.shape, generator=gen, device=cuda),
        0.0, 1.0)) for g in (1.0, 3.2, 10.0)]).cpu().pin_memory() for _ in range(2)]
    rec = ReconstructConfig()
    list(reconstruct_stream(brackets, cam, proj, cfg, rec=rec))      # builds and loads
    torch.cuda.synchronize()

    def unguarded(self):
        torch.cuda.set_sync_debug_mode("default")
        return obs.span.__enter__(self)

    def guarded(self, *exc):
        torch.cuda.set_sync_debug_mode("error")
        return obs.span.__exit__(self, *exc)

    monkeypatch.setattr(obs.wait, "__enter__", unguarded)
    monkeypatch.setattr(obs.wait, "__exit__", guarded)
    before = launches("k1", "k2")
    mark = max(s.id for s in obs.snapshot().spans)
    torch.cuda.set_sync_debug_mode("error")
    try:
        clouds = list(reconstruct_stream(brackets, cam, proj, cfg, rec=rec))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert [x - b for x, b in zip(launches("k1", "k2"), before)] == [0, 2]
    spans = sorted((s for s in obs.snapshot().spans if s.id > mark), key=lambda s: s.id)
    names = {s.id: s.name for s in spans}
    roots = [s for s in spans if s.parent == 0 and s.name == "scan"]
    assert len(roots) == 2
    for root in roots:
        assert [s.name for s in spans if s.parent == root.id] == [
            "hdr.colors", "k2.params", "k2.launch"]
    assert [(s.name, names[s.parent]) for s in spans if s.wait] == [
        ("params.read", "k2.params")] * 2
    for cloud, bracket in zip(clouds, brackets):
        b = bracket.to(cuda)
        p = fs.fused_decode_triangulate_hdr_reference(b, cam, proj, cfg, DecodeConfig(),
                                                      z_bounds=(rec.min_depth, rec.max_depth))
        k = fs.FusedScanOut(points=cloud.points.movedim(-1, 0), mask=cloud.mask.float(),
                            quality=cloud.quality, x_p=cloud.x_p, y_p=torch.zeros_like(cloud.x_p))
        _agrees(k, p, rows=False)
        w = b[:, 0].to(torch.float32) / 255.0
        assert torch.equal(cloud.colors, torch.where(w < 0.98, w, 0.0).amax(dim=0))
    for dtype, n in ((torch.uint8, 256), (torch.uint16, 65536)):
        c = torch.arange(n, device=cuda)
        stacks = torch.stack([c, (c * 7 + 3) % n, c.flip(0)])[:, None, None].to(
            torch.int32).to(dtype)
        for sat in (0.98, 0.5, 1.0):
            w = torch.stack([trec._white_color(s) for s in stacks])
            assert torch.equal(trec._bracket_colors(stacks, sat),
                               torch.where(w < sat, w, 0.0).amax(dim=0)), (dtype, sat)


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
    n = launches("k1")
    got = [tuple(x.clone() for x in c) for c in reconstruct_stream(
        iter(stacks), cam, proj, cfg, prefetch=prefetch)]
    torch.cuda.synchronize()
    assert launches("k1") - n == 4
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
    n1, n2 = launches("k1", "k2")
    c_gpu = on_card.reconstruct(0, **kw)
    torch.cuda.synchronize()
    assert c_gpu.points.device.type == "cuda"
    launched = (launches("k1") - n1, launches("k2") - n2)
    assert launched == {"hdr": (0, 1), "scan": (0, 0)}.get(route, (1, 0))
    _cloud_agrees_plain(c_gpu, c_cpu)
    for a, b in zip(on_card.load_cloud(0), c_gpu):
        assert torch.equal(a, b)


# --- the parallel tier in a process group of one rank over NCCL ----------------


@pytest.fixture
def nccl_world1(cuda, tmp_path):
    """A real NCCL process group of one rank (``init_distributed`` skips a
    single process), and its mesh; destroyed after the test."""
    import torch.distributed as dist

    from slr_torch.dist import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("spatial_iters", [0, 8])
@pytest.mark.parametrize("uint8", [False, True])
def test_sharded_reconstruct_in_a_world_of_one_rank(nccl_world1, spatial_iters, uint8):
    """``sharded_reconstruct`` on one rank: K1 once, then the haloed sweeps
    (K4 on the 1032-row block by the route rule, one launch an exchange),
    the unsharded composition's bits."""
    from slr_torch.dist import comm, sharded_reconstruct
    from slr_torch.geom.triangulate import triangulate_plane
    from slr_torch.pipeline.reconstruct import _pixel_grid

    dev = torch.device("cuda")
    cam, proj = default_rig(1280, 1024, device=dev)
    cfg = PatternConfig(proj_width=1024, proj_height=768, gray_bits=7, phase_steps=4)
    scan = render_scan(cam, proj, bumps_depth(1024, 1280, base=480.0, amp=30.0, device=dev),
                       cfg, noise_std=0.005, generator=torch.Generator(device=dev).manual_seed(0))
    frames = quantize_frames(scan.frames) if uint8 else scan.frames
    out = fs.fused_decode_triangulate(frames, cam, proj, cfg, DecodeConfig())
    mask, x_p, pts = out.mask > 0.5, out.x_p, out.points.movedim(0, -1)
    if spatial_iters:
        Phi = us.quality_unwrap(x_p * (2 * math.pi / cfg.fringe_pitch), out.quality, mask,
                                iters=spatial_iters)
        x_p = Phi * (cfg.fringe_pitch / (2 * math.pi))
        pts, _ = triangulate_plane(cam, proj, *_pixel_grid(1024, 1280, dev), x_p)
    before = launches("k1", "k3", "k4")
    comm.reset()
    got = sharded_reconstruct(frames, cam, proj, cfg, DecodeConfig(), nccl_world1,
                              spatial_iters=spatial_iters)
    for a, b in zip(got, (pts, mask, x_p, out.quality), strict=True):
        assert torch.equal(a, b)
    assert tuple(a - b for a, b in zip(launches("k1", "k3", "k4"), before)) == (
        1, 0, spatial_iters // 4)
    assert comm.calls["all_gather"] == 1 and comm.calls["ring"] == 0


@pytest.mark.parametrize("plane", [False, True])
def test_distributed_ba_in_a_world_of_one_rank(nccl_world1, plane):
    """The distributed BA on one rank over NCCL: one all-reduce an
    iteration, ``bundle_adjust_reference``'s bits on the card."""
    from chip_smoke import dist_ba_problem
    from slr_torch.dist import bundle_adjust_reference, comm, distributed_bundle_adjust

    pr = dist_ba_problem()
    args = [pr[k].cuda() for k in ("ba_R0", "ba_t0", "ba_X0", "ba_s", "ba_p", "ba_w")]
    n = torch.nn.functional.normalize(torch.randn(args[4].shape, generator=torch.Generator()
                                                  .manual_seed(0)), dim=-1).cuda()
    kw = dict(iters=6, huber_delta=1.0, obs_n=n if plane else None)
    comm.reset()
    got = distributed_bundle_adjust(*args, nccl_world1, **kw)
    assert comm.calls["all_reduce"] == 6 and comm.calls["all_gather"] == 1
    for a, b in zip(got, bundle_adjust_reference(*args, **kw)):
        assert torch.equal(a, b)


def _obj_sweep(device, seed, n=1 << 18):
    """A seeded sweep for the OBJ text kernels: millimetre coordinates and
    random bit patterns inside the domain (|x| < 9.2e12), NaN among them."""
    rng = np.random.default_rng(seed)
    mm = (rng.uniform(-2000.0, 2000.0, n) * 10.0 ** rng.integers(-6, 1, n)).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)
    bits = np.where(np.abs(bits) < 9.2e12, bits, mm)
    bits[::997] = np.nan
    x = np.concatenate([mm, bits])[: 2 * n - 2 * n % 3]
    verts = torch.from_numpy(np.ascontiguousarray(x.reshape(-1, 3))).to(device)
    cols = torch.from_numpy(x[: verts.shape[0]].copy()).to(device)
    faces = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, (4096, 3)).astype(np.int32)).to(device)
    return verts, cols, faces


@pytest.mark.parametrize("with_colors", [True, False])
@pytest.mark.parametrize("case", ["edges", "sweep"])
def test_obj_text_kernel_matches_plain(cuda, case, with_colors):
    """The OBJ text kernels' bytes equal to the plain version's on the CPU
    and to Python's f-strings; two launches a text; a position past the
    domain refused with ``ValueError``."""
    from chip_smoke import fstring_obj_lines, obj_edge_case
    from slr_torch.kernels import obj_text as ot

    verts, cols, faces = obj_edge_case(cuda) if case == "edges" else _obj_sweep(cuda, 5)
    cols = cols if with_colors else None
    n = launches("obj_text")
    got = ot.format_obj(verts, cols, faces)
    assert launches("obj_text") - n == 2
    cpu = [None if t is None else t.cpu() for t in (verts, cols, faces)]
    assert torch.equal(got, ot.format_obj(*cpu))
    assert got.numpy().tobytes() == fstring_obj_lines(*cpu)
    with pytest.raises(ValueError, match="domain"):
        ot.format_obj(torch.tensor([[0.0, -1e13, 0.0]], device=cuda), None, faces[:0])


def test_tsdf_writer_on_the_card_matches_fstring_writer(cuda, tmp_path):
    """``write_tsdf_mesh_obj`` on a card volume: the file the writer wrote
    with f-strings, for the mesh it extracts on the card."""
    from chip_smoke import OBJ_HEADER, fstring_obj_lines
    from slr_torch.pipeline import tsdf

    n = 48
    z, y, x = torch.meshgrid(*(torch.arange(n, dtype=torch.float32, device=cuda),) * 3,
                             indexing="ij")
    d = torch.sqrt((x - 23.5) ** 2 + (y - 23.5) ** 2 + (z - 23.5) ** 2) * 2.0
    weight = torch.full_like(d, 2.0)
    vol = tsdf.TSDFVolume(torch.clamp((34.0 - d) / 6.0, -1.0, 1.0), weight,
                          (z / n * 1.4 - 0.2) * weight,
                          torch.tensor([-40.0, 12.5, 480.0], device=cuda),
                          torch.tensor(2.0, device=cuda), torch.tensor(6.0, device=cuda))
    n0 = launches("obj_text")
    nv, nf = tsdf.write_tsdf_mesh_obj(tmp_path / "m.obj", vol)
    assert launches("obj_text") - n0 == 2 and nf > 1000
    verts, faces, cols = tsdf.extract_mesh(vol, with_colors=True)
    want = OBJ_HEADER + fstring_obj_lines(verts, torch.clamp(cols, 0.0, 1.0), faces)
    assert (tmp_path / "m.obj").read_bytes() == want


# ---------------------------------------------------------------- the pose graph

@pytest.mark.parametrize("case", list(POSE_GRAPH_CASES))
def test_pose_graph_kernel_matches_plain_version(cuda, case):
    """The whole solve in one launch against the plain version (jacfwd,
    cholesky_solve) on the card, within the JAX parity test's tolerances
    (the CPU test ``test_pose_graph_cases_match_jax`` holds the plain
    version to JAX on the same graphs); two calls the same bits."""
    spec = POSE_GRAPH_CASES[case]
    args = pose_graph_case(cuda, *spec["graph"])
    n = launches("pose_graph")
    got = pg.pose_graph_optimize(*args, **spec["solve"])
    assert launches("pose_graph") - n == 1
    want = pg.pose_graph_optimize_reference(*args, **spec["solve"])
    agree = pose_graph_agreement(got, want)
    assert agree["within"], agree
    again = pg.pose_graph_optimize(*args, **spec["solve"])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_pose_graph_kernel_reads_nothing_on_the_host(cuda):
    """One launch, no host synchronisation (torch's sync debug mode raises
    on one), in shared memory and on the workspace."""
    for case in ("config5_closures", "poses_48"):
        args = pose_graph_case(cuda, *POSE_GRAPH_CASES[case]["graph"])
        pg.pose_graph_optimize(*args)
        torch.cuda.synchronize()
        n = launches("pose_graph")
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = pg.pose_graph_optimize(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert launches("pose_graph") - n == 1
        assert 0.1 < float(res.rms) < 0.3


@pytest.mark.parametrize("E", [207, 208])
def test_pose_graph_at_the_shared_memory_limit(cuda, E):
    """32 poses and 207 edges, the most that shared memory holds, and 208,
    on the workspace: both one launch, within the tolerances."""
    args = pose_graph_case(cuda, 32, pose_graph_edges(32, E), 5, 0.002, 0.05, 20.0)
    assert kpg.in_shared(32, E) == (E == 207)
    n = launches("pose_graph")
    got = pg.pose_graph_optimize(*args)
    assert launches("pose_graph") - n == 1
    agree = pose_graph_agreement(got, pg.pose_graph_optimize_reference(*args))
    assert agree["within"], agree


def test_pose_graph_kernel_bad_input(cuda):
    """An edge past the poses makes every output NaN; other dtypes (the
    card's route is float32 alone), devices and shapes are refused."""
    args = list(pose_graph_case(cuda, *POSE_GRAPH_CASES["two_poses"]["graph"]))
    bad = pg.pose_graph_optimize(*args[:3], torch.tensor([2], device=cuda), *args[4:])
    assert all(bool(torch.isnan(x).all()) for x in bad)
    with pytest.raises(ValueError):
        pg.pose_graph_optimize(*(a.double() if a.is_floating_point() else a for a in args))
    with pytest.raises(ValueError):
        kpg.solve(args[0].double(), *args[1:], 20, 1e-6, 300.0)
    with pytest.raises(ValueError):
        kpg.solve(*[a.cpu() for a in args], 20, 1e-6, 300.0)
    with pytest.raises(ValueError):
        kpg.solve(*args[:4], args[4][:, :2], args[5], 20, 1e-6, 300.0)


# ---------------------------------------------------------------- ICP in one launch

@pytest.mark.parametrize("masked", [False, True])
def test_icp_kernel_matches_plain_version(cuda, masked):
    """The NN route in one launch against the plain loop on the card
    (``nn_method="exact"``) on the plain parity tests' case near the
    origin, plain and with masks and an initial pose: within their
    tolerances (R 1e-5, t 1e-3 mm, inlier_frac 1e-3)."""
    kw, _ = icp_case(cuda, 1500, 7 + masked, masked=masked)
    n = launches("icp")
    got = icp_point_to_plane(**kw, iters=12, max_corr_dist=20.0)
    assert launches("icp") - n == 1
    want = icp_point_to_plane_reference(**kw, iters=12, max_corr_dist=20.0, nn_method="exact")
    agree = icp_agreement(got, want, ICP_TOL)
    assert agree["within"], agree
    assert float(got.rms) < 0.2


def test_icp_polish_matches_plain_version(cuda):
    """The projective route in one launch against the plain loop on the
    card, on the plain parity test's organized grid."""
    args, _ = icp_grid_case(cuda)
    n = launches("icp_polish")
    got = rp.icp_projective(*args, iters=10, max_corr_dist=10.0)
    assert launches("icp_polish") - n == 1
    want = rp.icp_projective_reference(*args, iters=10, max_corr_dist=10.0)
    agree = icp_agreement(got, want, ICP_TOL)
    assert agree["within"], agree
    np.testing.assert_allclose(float(got.rms), float(want.rms), rtol=1e-3, atol=1e-5)


def test_icp_on_a_config5_edge_matches_plain_version(cuda):
    """An edge of config 5's orbit at scan coordinates (its first two uint8
    scans through K1, 4096 samples each, the defaults; scan 0 onto scan 1,
    the polish on scan 1's grid): the NN route and then the polish, each
    against its plain version on the card,
    within the route's limits on config 5's chain round (``ICP_EDGE_TOL``,
    25 to 1,000 times tighter than fusion_orbit8's 0.25 deg and 0.5 mm)."""
    from slr_torch.config import PatternConfig, RegistrationConfig
    from slr_torch.pipeline import registerfuse as rf
    from slr_torch.registration.normals import grid_normals

    cam, proj = default_rig(cam_w=1280, cam_h=1024)
    cfg = PatternConfig(proj_width=1024, proj_height=768, gray_bits=7, phase_steps=4)
    stacks, _, _ = render_orbit(cuda, cam, proj, cfg, scans=2)
    model = DenseReconstructor(cam, proj, cfg).to(cuda)
    clouds = [model(f) for f in stacks]
    rc = RegistrationConfig()
    (src, _), (tgt, nrm) = (rf._subsample(c, rc.icp_sample_points, seed=i)
                            for i, c in enumerate(clouds))
    kw = dict(iters=rc.icp_iters, max_corr_dist=rc.icp_max_corr_dist)
    got = icp_point_to_plane(src, tgt, nrm, **kw)
    want = icp_point_to_plane_reference(src, tgt, nrm, nn_method="exact", **kw)
    agree = icp_agreement(got, want, ICP_EDGE_TOL["nn"])
    assert agree["within"], agree
    ones = torch.ones(src.shape[0], dtype=torch.bool, device=cuda)
    grid = (clouds[1].points, clouds[1].mask, grid_normals(clouds[1].points, clouds[1].mask))
    kw["iters"] = max(8, rc.icp_iters // 2)
    cam_d = cam.to(cuda)
    got_p = rp.icp_projective(src, ones, *grid, cam_d, R0=got.R, t0=got.t, **kw)
    want_p = rp.icp_projective_reference(src, ones, *grid, cam_d, R0=want.R, t0=want.t, **kw)
    agree = icp_agreement(got_p, want_p, ICP_EDGE_TOL["polish"])
    assert agree["within"], agree


def _icp_batch(cuda, E):
    """E edges of the parity case, each its own seed: stacked keyword
    arguments of ``kicp.align``, and the per-edge ones."""
    cases = [icp_case(cuda, 1000, 20 + e, masked=True)[0] for e in range(E)]
    names = ("src", "tgt", "tgt_n", "src_valid", "tgt_valid", "R0", "t0")
    keys = ("src", "tgt", "tgt_normals", "src_valid", "tgt_valid", "R0", "t0")
    return {n: torch.stack([c[k] for c in cases]) for n, k in zip(names, keys)}, cases


def test_icp_batch_gives_each_edge_its_single_call_bits(cuda):
    """A batch of E edges in one launch gives each edge the bits it gets
    in a call of its own, on both routes; two calls give the same bits."""
    batch, cases = _icp_batch(cuda, 4)
    n = launches("icp")
    got = ICPResult(*kicp.align(**batch, iters=10, max_corr_dist=15.0))
    again = ICPResult(*kicp.align(**batch, iters=10, max_corr_dist=15.0))
    assert launches("icp") - n == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for e, c in enumerate(cases):
        one = icp_point_to_plane(**c, iters=10, max_corr_dist=15.0)
        assert all(torch.equal(a[e], b) for a, b in zip(got, one)), e
    (src, valid, grid, mask, normals, cam), _ = icp_grid_case(cuda)
    grids = (torch.stack([grid, grid + 0.5]), torch.stack([mask, mask]),
             torch.stack([normals, normals]))
    srcs = torch.stack([src, src, src - 0.25])
    grid_of = torch.tensor([1, 0, 1], device=cuda)
    n = launches("icp_polish")
    got = ICPResult(*kicp.polish(srcs, None, *grids, grid_of, cam, iters=10))
    again = ICPResult(*kicp.polish(srcs, None, *grids, grid_of, cam, iters=10))
    assert launches("icp_polish") - n == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ones = torch.ones(src.shape[0], dtype=torch.bool, device=cuda)
    for e in range(3):
        g = int(grid_of[e])
        one = rp.icp_projective(srcs[e], ones, grids[0][g], grids[1][g], grids[2][g], cam,
                                iters=10)
        assert all(torch.equal(a[e], b) for a, b in zip(got, one)), e


def test_icp_kernels_launch_once_without_host_sync(cuda):
    """One launch a call on each route, and no host synchronisation in the
    call (torch's sync debug mode raises on one)."""
    kw, _ = icp_case(cuda, 1500, 7, masked=True)
    args, _ = icp_grid_case(cuda)
    icp_point_to_plane(**kw)
    rp.icp_projective(*args)
    torch.cuda.synchronize()
    n = launches("icp", "icp_polish")
    torch.cuda.set_sync_debug_mode("error")
    try:
        icp_point_to_plane(**kw)
        rp.icp_projective(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tuple(b - a for a, b in zip(n, launches("icp", "icp_polish"))) == (1, 1)


def test_icp_without_correspondences_keeps_the_initial_pose(cuda):
    """An edge with no correspondence within max_corr_dist (its target 1 m
    away; on the grid, every pixel masked), or no source point at all,
    gives rms = inf, inlier_frac 0 and the initial pose, as the plain loop
    does."""
    kw, _ = icp_case(cuda, 1000, 9, masked=True)
    kw["tgt"] = kw["tgt"] + 1000.0
    empty = {**kw, "src": kw["src"][:0], "src_valid": kw["src_valid"][:0]}
    for case in (kw, empty):
        n = launches("icp")
        got = icp_point_to_plane(**case, iters=5)
        assert launches("icp") - n == 1
        want = icp_point_to_plane_reference(**case, iters=5, nn_method="exact")
        for r in (got, want):
            assert float(r.rms) == math.inf and float(r.inlier_frac) == 0.0
            assert torch.equal(r.R, kw["R0"]) and torch.equal(r.t, kw["t0"])
    (src, valid, grid, mask, normals, cam), _ = icp_grid_case(cuda)
    R0, t0 = kw["R0"], kw["t0"]
    for fn in (rp.icp_projective, rp.icp_projective_reference):
        r = fn(src, valid, grid, torch.zeros_like(mask), normals, cam, R0=R0, t0=t0, iters=5)
        assert float(r.rms) == math.inf and float(r.inlier_frac) == 0.0
        assert torch.equal(r.R, R0) and torch.equal(r.t, t0)


def test_icp_past_shared_memory_stages_the_target_in_chunks(cuda):
    """A target past a block's shared memory (14,428 points) takes the
    kernel too, one launch, staged a chunk at a time. At the edge and one
    point past it: within the parity tolerances of the plain loop. The
    parity case's 1,500 targets padded with masked ones to three chunks,
    the real ones across the first two: the bits of one staging.
    ``nn_method="exact"`` past the crossover takes it as well, with the
    same bits."""
    M = kicp.CHUNK
    for m in (M, M + 1):
        kw, _ = icp_case(cuda, m, 11, masked=True)
        kw.update(src=kw["src"][:512], src_valid=kw["src_valid"][:512])
        assert kicp.takes_kernel(512, m, cuda)
        n = launches("icp")
        got = icp_point_to_plane(**kw, iters=4)
        assert launches("icp") - n == 1
        want = icp_point_to_plane_reference(**kw, iters=4, nn_method="exact")
        agree = icp_agreement(got, want, ICP_TOL)
        assert agree["within"], (m, agree)
    kw, _ = icp_case(cuda, 1500, 11, masked=True)
    lo, hi = M - 700, M + 5          # 2 M + 805 targets: three chunks

    def pad(x, value):
        fill = x.new_full((1, *x.shape[1:]), value)
        return torch.cat([fill.expand(lo, *x.shape[1:]), x, fill.expand(hi, *x.shape[1:])])

    padded = dict(tgt=pad(kw["tgt"], 1e4), tgt_normals=pad(kw["tgt_normals"], 0.0),
                  tgt_valid=pad(kw["tgt_valid"], False))
    whole = icp_point_to_plane(**kw, iters=4)
    n = launches("icp")
    got = icp_point_to_plane(**{**kw, **padded}, iters=4)
    assert launches("icp") - n == 1
    assert all(torch.equal(a, b) for a, b in zip(got, whole))
    many = {**kw, "src": kw["src"].repeat(14, 1), "src_valid": kw["src_valid"].repeat(14)}
    assert _resolve_nn_method("auto", 21_000, 2 * M + 805, cuda) == "band"
    n = launches("icp")
    got = icp_point_to_plane(**{**many, **padded}, iters=2, nn_method="exact")
    assert launches("icp") - n == 1
    want = icp_point_to_plane(**many, iters=2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_icp_kernels_bad_input(cuda):
    """Other dtypes (on either route, and through ``icp_point_to_plane``),
    devices and shapes are refused with ``ValueError``; a grid index past
    the grids makes that edge's outputs NaN."""
    batch, _ = _icp_batch(cuda, 2)
    with pytest.raises(ValueError):
        kicp.align(**{**batch, "src": batch["src"].double()})
    with pytest.raises(ValueError):
        kicp.align(**{**batch, "tgt_n": batch["tgt_n"][:, :, :2]})
    with pytest.raises(ValueError):
        kicp.align(**{k: v.cpu() for k, v in batch.items()})
    with pytest.raises(ValueError):
        icp_point_to_plane(*(batch[k][0].double() for k in ("src", "tgt", "tgt_n")))
    (src, valid, grid, mask, normals, cam), _ = icp_grid_case(cuda)
    with pytest.raises(ValueError):
        rp.icp_projective(src.double(), valid, grid.double(), mask, normals.double(),
                          cam)
    with pytest.raises(ValueError, match="grid_of"):
        kicp.polish(torch.stack([src, src]), None, grid[None], mask[None], normals[None],
                    None, cam)
    bad = kicp.polish(torch.stack([src, src]), None, grid[None], mask[None], normals[None],
                      torch.tensor([0, 1], device=cuda), cam)
    assert all(bool(torch.isnan(x[1]).all()) and not bool(torch.isnan(x[0]).any())
               for x in bad)
