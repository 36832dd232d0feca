"""The port's CUDA kernels (K1, every branch, and K2) against their plain
PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
"""

import pytest
import torch

from slr_torch.config import DecodeConfig, PatternConfig
from slr_torch.geom.camera import make_camera
from slr_torch.kernels import fused_scan as fs
from slr_torch.pipeline.reconstruct import DenseReconstructor, accumulate_by_projector
from slr_torch.synth.render import default_rig, quantize_frames, render_scan
from slr_torch.synth.scene import bumps_depth, checker_albedo

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
