"""The port's CUDA kernels (K1, every branch, K2, the spatial repair's K3, K4
and K5, the band search K8, and the crossing kernels K6 and K7 of the
two-camera merge) against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
"""

import math

import numpy as np
import pytest
import torch

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
            assert float((Pk - Pp).abs().max()) <= 1e-3
            assert int(dk.sum()) > int(args[3].sum())


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
    the pose of the same ICP on the CPU (K8's plain version)."""
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
    ref = icp_point_to_plane(*args, iters=6, max_corr_dist=8.0)
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
    equal their plain versions; one code wider is refused."""
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
    lo, hi, pay, _ = kx.crossing_pairs(*_crossing_case(cuda, 5, Up + 1, 6, 0.3)[:3], INTERP)
    out = kx.launch_bin_sum(lo, hi, pay, 1024)
    ref = kx.crossing_bin_sum_reference(lo, hi, pay, 1024)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="shared memory"):
        kx.launch_bin_sum(*kx.crossing_pairs(*_crossing_case(cuda, 2, Up + 2, 6)[:3],
                                             INTERP)[:3], 1024)


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
