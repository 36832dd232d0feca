"""slr_torch fused scan (K1, every branch) against the JAX reference kernel
(CPU). K2, the HDR bracket kernel, is tests/test_torch_hdr.py.

The port's plain PyTorch version of the kernel is held to
``slr.kernels.fused_decode_triangulate`` run in Pallas interpret mode (as
the JAX package's own tests run it), on the same numpy frames; the CUDA
kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py).

Tolerances, and why: the JAX kernel uses a polynomial atan2 (error up to
~1e-6 rad), and the port's ray math may round differently in the last ulp.
Either can flip a Gray bit or a fringe order on the rare pixel sitting
exactly on a code edge, so masks and x_p are bounded as fractions of
pixels: mask disagreement <= 1e-3 of pixels, |dx_p| <= 1e-3 px on all but
1e-4 of the mutually valid pixels, |dpoints| <= 1e-2 mm on the pixels whose
x_p agrees, |dquality| <= 1e-5 everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slr.config import DecodeConfig as JDecodeConfig
from slr.config import PatternConfig as JPatternConfig
from slr.kernels import fused_decode_triangulate as jax_fused
from slr.synth import bumps_depth
from slr.synth.render import default_rig, render_scan
from slr_torch import observability as obs
from slr_torch.codec.patterns import decode_stack
from slr_torch.config import DecodeConfig, PatternConfig
from slr_torch.geom.camera import camera_from_numpy
from slr_torch.geom.triangulate import triangulate_plane
from slr_torch.kernels import fused_scan as fs

torch.set_num_threads(2)

CFG = dict(proj_width=256, proj_height=192, gray_bits=6, phase_steps=4)


def _render(w, h, amp, noise):
    """Noiseless JAX render (+ seeded numpy noise, clipped) and the rig as
    the port's cameras."""
    cam, proj = default_rig(cam_w=w, cam_h=h, proj_w=256, proj_h=192,
                            baseline=150.0, toe_in_deg=14.0)
    scan = render_scan(cam, proj, bumps_depth(h, w, base=480.0, amp=amp),
                       JPatternConfig(**CFG))
    frames = np.array(scan.frames)
    if noise:
        rng = np.random.default_rng(1)
        frames = np.clip(frames + noise * rng.standard_normal(frames.shape)
                         .astype(np.float32), 0, 1).astype(np.float32)
    as_np = lambda c: jax.tree.map(np.asarray, c)  # noqa: E731
    return (cam, proj, frames, camera_from_numpy(as_np(cam)),
            camera_from_numpy(as_np(proj)), np.asarray(scan.mask_true),
            np.asarray(scan.points_true))


def assert_scan_agrees(mask_a, mask_b, xp_a, xp_b, pts_a, pts_b, q_a, q_b):
    """The tolerances of the module docstring; pts are (..., H, W)."""
    assert (mask_a != mask_b).mean() <= 1e-3
    both = mask_a & mask_b
    assert both.mean() > 0.3
    dx = np.abs(xp_a - xp_b)
    assert (dx[both] > 1e-3).mean() <= 1e-4, dx[both].max()
    agree = both & (dx <= 1e-3)
    assert np.abs(pts_a - pts_b)[..., agree].max() <= 1e-2
    assert np.abs(q_a - q_b).max() <= 1e-5


@pytest.mark.parametrize("w,h,amp,noise", [(320, 256, 25.0, 0.005),
                                           (300, 215, 20.0, 0.0)])
def test_plain_version_matches_jax_kernel(w, h, amp, noise):
    camj, projj, frames, cam, proj, _, _ = _render(w, h, amp, noise)
    oj = jax_fused(jnp.asarray(frames), camj, projj, JPatternConfig(**CFG),
                   JDecodeConfig())
    ot = fs.fused_decode_triangulate_reference(
        torch.from_numpy(frames), cam, proj, PatternConfig(**CFG), DecodeConfig())
    assert tuple(ot.points.shape) == (3, h, w)
    assert all(x.dtype == torch.float32 for x in ot)
    assert_scan_agrees(np.asarray(oj.mask) > 0.5, ot.mask.numpy() > 0.5,
                       np.asarray(oj.x_p), ot.x_p.numpy(),
                       np.asarray(oj.points), ot.points.numpy(),
                       np.asarray(oj.quality), ot.quality.numpy())
    np.testing.assert_array_equal(ot.y_p.numpy(), 0.0)
    # invalid pixels carry zero points in both
    invalid = ot.mask.numpy() < 0.5
    assert np.all(ot.points.numpy()[:, invalid] == 0.0)


def test_plain_version_matches_unfused_port():
    """Within the port: fused plain version == decode_stack + triangulate_plane
    (the same check tests/test_kernels.py makes of the JAX kernel)."""
    _, _, frames, cam, proj, _, _ = _render(320, 256, 25.0, 0.005)
    cfg, dec = PatternConfig(**CFG), DecodeConfig()
    ft = torch.from_numpy(frames)
    out = fs.fused_decode_triangulate_reference(ft, cam, proj, cfg, dec)
    ref = decode_stack(ft, cfg, dec)
    v, u = torch.meshgrid(torch.arange(256.0), torch.arange(320.0), indexing="ij")
    pts, _ = triangulate_plane(cam, proj, u, v, ref.x_p)
    # the kernel adds the z bounds to the mask; the unfused path does not
    assert_scan_agrees(out.mask.numpy() > 0.5, ref.mask.numpy(),
                       out.x_p.numpy(), ref.x_p.numpy(),
                       out.points.numpy(), pts.permute(2, 0, 1).numpy(),
                       out.quality.numpy(), ref.quality.numpy())


def test_plain_version_accuracy_vs_ground_truth():
    _, _, frames, cam, proj, mask_true, pts_true = _render(320, 256, 25.0, 0.0)
    out = fs.fused_decode_triangulate_reference(
        torch.from_numpy(frames), cam, proj, PatternConfig(**CFG), DecodeConfig())
    valid = (out.mask.numpy() > 0.5) & mask_true
    err = np.linalg.norm(out.points.numpy().transpose(1, 2, 0) - pts_true, axis=-1)
    assert np.sqrt(np.mean(err[valid] ** 2)) < 0.5


def test_cpu_wrapper_takes_plain_route():
    _, _, frames, cam, proj, _, _ = _render(160, 128, 20.0, 0.0)
    cfg, dec = PatternConfig(**CFG), DecodeConfig()
    ft = torch.from_numpy(frames)
    before = obs.snapshot().counts.get("launches.k1", 0)
    a = fs.fused_decode_triangulate(ft, cam, proj, cfg, dec)
    b = fs.fused_decode_triangulate_reference(ft, cam, proj, cfg, dec)
    assert obs.snapshot().counts.get("launches.k1", 0) == before  # no kernel launch
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fs.launch_fused_scan(ft, fs.scan_params(cam, proj, cfg, dec, (1.0, 1e4),
                                                8, 128, 160))


def _bad(kind, cam, proj):
    cfg = PatternConfig(**CFG)
    if kind == "no_inverse":
        cfg = PatternConfig(**CFG, use_inverse=False)
    dtype = {"int16": torch.int16, "float64": torch.float64}.get(kind, torch.float32)
    frames = torch.zeros((cfg.num_frames, 8, 8), dtype=dtype)
    if kind == "frame_count":
        frames = frames[1:]
    if kind == "R!=I":
        cam = cam._replace(R=proj.R)
    if kind == "t!=0":
        cam = cam._replace(t=torch.tensor([0.0, 1.0, 0.0]))
    if kind == "no_projector":
        proj = None
    return frames, cam, proj, cfg


@pytest.mark.parametrize("kind,exc,match", [
    ("no_inverse", ValueError, "inverse Gray patterns"),
    ("int16", ValueError, "float32, uint8 or uint16"),
    ("float64", ValueError, "float32, uint8 or uint16"),
    ("frame_count", ValueError, "F = 18"),
    ("no_projector", ValueError, "projector model"),
    ("R!=I", ValueError, "world origin"),
    ("t!=0", ValueError, "world origin"),
])
def test_wrapper_and_plain_version_refuse_outside_contract(kind, exc, match):
    from slr_torch.synth.render import default_rig as rig

    cam, proj = rig(cam_w=8, cam_h=8, proj_w=256, proj_h=192)
    frames, cam, proj, cfg = _bad(kind, cam, proj)
    for fn in (fs.fused_decode_triangulate, fs.fused_decode_triangulate_reference):
        with pytest.raises(exc, match=match):
            fn(frames, cam, proj, cfg, DecodeConfig())
    if kind in ("R!=I", "t!=0"):  # the kernel's parameter block refuses too
        with pytest.raises(exc, match=match):
            fs.scan_params(cam, proj, cfg, DecodeConfig(), (1.0, 1e4), 8, 8, 8)


def test_scan_params_carry_the_calibration():
    from slr_torch.synth.render import default_rig as rig

    cam, proj = rig(cam_w=320, cam_h=256, proj_w=256, proj_h=192,
                    cam_dist=[0.1, -0.02, 0.001, 0.002, 0.01])
    cfg, dec = PatternConfig(**CFG), DecodeConfig()
    p = fs.scan_params(cam, proj, cfg, dec, (2.0, 900.0), 6, 256, 320)
    assert (p.height, p.width, p.bits, p.steps, p.undistort_iters) == (256, 320, 6, 4, 6)
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    assert (p.tau_black, p.tau_white, p.tau_mod) == (
        f32(dec.black_threshold), f32(dec.white_threshold),
        f32(dec.modulation_threshold))
    assert (p.zmin, p.zmax) == (2.0, 900.0)
    assert [p.fx, p.fy, p.cx, p.cy] == [float(cam.fx), float(cam.fy),
                                        float(cam.cx), float(cam.cy)]
    assert [p.k1, p.k2, p.p1, p.p2, p.k3] == cam.dist.tolist()
    assert [p.pfx, p.pcx] == [float(proj.fx), float(proj.cx)]
    assert list(p.R) == proj.R.reshape(-1).tolist()
    assert list(p.C) == proj.center.tolist()
    assert list(p.sin_d[:4]) == [f32(np.sin(2 * np.pi * k / 4)) for k in range(4)]
    assert list(p.cos_d[:4]) == [f32(np.cos(2 * np.pi * k / 4)) for k in range(4)]
    assert p.w_coded == 256.0 and p.w_fold == 255.5
    assert p.xp_scale == f32(np.float32(4.0) / np.float32(2 * np.pi))


# --- the other branches of K1, each against the JAX kernel in interpret mode

PROJ_DIST = [-0.08, 0.02, 0.001, -0.001, 0.0]
BRANCHES = {
    # name: (PatternConfig fields, ADC bits of the integer frames or None,
    #        projector distortion)
    "uint8": (CFG, 8, None),
    "uint16_bit_depth_12": (CFG, 12, None),
    "gray_only": (dict(proj_width=256, proj_height=192, gray_bits=7,
                       phase_steps=0), None, None),
    "midpoint": (dict(CFG, row_gray_bits=6), None, PROJ_DIST),
    "midpoint_row_phase": (dict(CFG, row_gray_bits=6, row_phase_steps=4),
                           None, PROJ_DIST),
    "multifreq": (dict(proj_width=256, proj_height=192, coding="multifreq",
                       phase_steps=4, mf_levels=3, mf_ratio=6.0), None, None),
    "decode_only": (dict(CFG, row_gray_bits=5, row_phase_steps=4), 8, None),
}


def _branch_frames(name):
    """JAX render of the branch's scene at 320x256, seeded numpy noise
    (none for the midpoint branches, as the reference benchmarks them),
    quantized to the branch's ADC bits."""
    kw, adc_bits, proj_dist = BRANCHES[name]
    cam, proj = default_rig(cam_w=320, cam_h=256, proj_w=256, proj_h=192,
                            baseline=150.0, toe_in_deg=14.0, proj_dist=proj_dist)
    scan = render_scan(cam, proj, bumps_depth(256, 320, base=480.0, amp=25.0),
                       JPatternConfig(**kw))
    frames = np.array(scan.frames)
    if proj_dist is None:
        rng = np.random.default_rng(3)
        frames = np.clip(frames + 0.005 * rng.standard_normal(frames.shape)
                         .astype(np.float32), 0, 1).astype(np.float32)
    if adc_bits:
        m = (1 << adc_bits) - 1
        frames = np.clip(np.round(frames * m), 0, m).astype(
            np.uint8 if adc_bits == 8 else np.uint16)
    return cam, proj, frames, kw, adc_bits


@pytest.mark.parametrize("name", list(BRANCHES))
def test_branch_plain_version_matches_jax_kernel(name):
    camj, projj, frames, kw, adc_bits = _branch_frames(name)
    opts = dict(bit_depth=12) if adc_bits == 12 else {}
    cam = camera_from_numpy(jax.tree.map(np.asarray, camj))
    proj = camera_from_numpy(jax.tree.map(np.asarray, projj))
    if name == "decode_only":
        # camera 2 of a two-camera rig: posed, and no projector model
        from slr.geom.camera import make_camera

        camj = make_camera(camj.fx, camj.fy, camj.cx, camj.cy, R=projj.R, t=projj.t)
        cam = camera_from_numpy(jax.tree.map(np.asarray, camj))
        projj = proj = None
        opts = dict(decode_only=True)
    oj = jax_fused(jnp.asarray(frames), camj, projj, JPatternConfig(**kw),
                   JDecodeConfig(), **opts)
    ot = fs.fused_decode_triangulate(torch.from_numpy(frames), cam, proj,
                                     PatternConfig(**kw), DecodeConfig(), **opts)
    assert all(x.dtype == torch.float32 for x in ot)
    mj, mt = np.asarray(oj.mask) > 0.5, ot.mask.numpy() > 0.5
    assert_scan_agrees(mj, mt, np.asarray(oj.x_p), ot.x_p.numpy(),
                       np.asarray(oj.points), ot.points.numpy(),
                       np.asarray(oj.quality), ot.quality.numpy())
    both = mj & mt
    dy = np.abs(np.asarray(oj.y_p) - ot.y_p.numpy())
    if kw.get("row_gray_bits"):  # y_p held like x_p where rows are coded
        assert (dy[both] > 1e-3).mean() <= 1e-4, dy[both].max()
        assert np.abs(ot.y_p.numpy()[both]).max() > 0
    else:
        np.testing.assert_array_equal(ot.y_p.numpy(), 0.0)
    invalid = ot.mask.numpy() < 0.5
    assert np.all(ot.points.numpy()[:, invalid] == 0.0)
    if name == "decode_only":
        assert np.all(ot.points.numpy() == 0.0)


@pytest.mark.parametrize("name,rms_max", [
    ("uint8", 0.5), ("gray_only", 5.0), ("midpoint", 2.0),
    ("midpoint_row_phase", 0.01), ("multifreq", 0.5)])
def test_branch_accuracy_vs_ground_truth(name, rms_max):
    """Each branch's plain version against the render's ground truth, with
    the JAX kernel tests' own bounds (row phase: noiseless, 0.01 mm)."""
    kw, adc_bits, proj_dist = BRANCHES[name]
    camj, projj = default_rig(cam_w=320, cam_h=256, proj_w=256, proj_h=192,
                              baseline=150.0, toe_in_deg=14.0, proj_dist=proj_dist)
    scan = render_scan(camj, projj, bumps_depth(256, 320, base=480.0, amp=25.0),
                       JPatternConfig(**kw))
    _, _, frames, _, _ = _branch_frames(name)
    out = fs.fused_decode_triangulate(
        torch.from_numpy(frames), camera_from_numpy(jax.tree.map(np.asarray, camj)),
        camera_from_numpy(jax.tree.map(np.asarray, projj)), PatternConfig(**kw),
        DecodeConfig())
    valid = (out.mask.numpy() > 0.5) & np.asarray(scan.mask_true)
    assert valid.mean() > 0.3
    err = np.linalg.norm(out.points.numpy().transpose(1, 2, 0)
                         - np.asarray(scan.points_true), axis=-1)[valid]
    assert np.sqrt(np.mean(err ** 2)) < rms_max


def test_integer_thresholds_are_raw_counts():
    """uint8 frames gate on int(round(tau * 255)) raw counts, strictly, as
    the TPU kernel does: a contrast of exactly 26 counts is masked by K1
    (26 > 26 fails) but kept by decode_stack on frames / 255
    (26/255 > 0.1 holds)."""
    cfg, dec = PatternConfig(**CFG), DecodeConfig()
    c = fs._constants(cfg, dec, torch.uint8)
    assert (c["tau_black"], c["tau_white"]) == (26, 5)
    assert c["tau_mod"] == float(np.float32(0.05 * 255))
    assert c["mod_out_scale"] == float(np.float32(1 / 255))
    c12 = fs._constants(cfg, dec, torch.uint16, bit_depth=12, saturation=0.98)
    assert (c12["tau_black"], c12["tau_white"], c12["tau_sat"]) == (410, 82, 4013)
    _, _, frames, _, _ = _branch_frames("uint8")
    f = torch.from_numpy(frames).clone()
    f[1] = (f[0].to(torch.int32) - 26).clamp(min=0).to(torch.uint8)
    exact = (f[0].to(torch.int32) - f[1].to(torch.int32)) == 26
    assert exact.sum() > 1000
    cam, proj = (camera_from_numpy(jax.tree.map(np.asarray, c))
                 for c in default_rig(cam_w=320, cam_h=256, proj_w=256,
                                      proj_h=192, baseline=150.0, toe_in_deg=14.0))
    out = fs.fused_decode_triangulate(f, cam, proj, cfg, dec)
    assert not bool((out.mask > 0.5)[exact].any())
    assert bool(decode_stack(f, cfg, dec).mask[exact].any())


def test_plain_version_keeps_integer_arithmetic_exact():
    """uint8 subtraction would wrap in torch (3 - 200 = 59) and uint16 has no
    subtraction: the plain version widens to int32 first, so a black frame
    brighter than the white one is a negative contrast, masked."""
    cfg, dec = PatternConfig(**CFG), DecodeConfig()
    _, _, frames, _, _ = _branch_frames("uint8")
    cam, proj = (camera_from_numpy(jax.tree.map(np.asarray, c))
                 for c in default_rig(cam_w=320, cam_h=256, proj_w=256,
                                      proj_h=192, baseline=150.0, toe_in_deg=14.0))
    f = torch.from_numpy(frames).clone()
    f[0], f[1] = 3, 200
    assert not bool((fs.fused_decode_triangulate(f, cam, proj, cfg, dec).mask > 0.5).any())
    f16 = f.to(torch.int32).to(torch.uint16)
    assert not bool((fs.fused_decode_triangulate(f16, cam, proj, cfg, dec).mask > 0.5).any())


def test_row_offset_shifts_the_camera_rows():
    """row_offset is the global camera row of frame row 0: decoding the
    bottom half with row_offset = 128 gives the full scan's bottom half."""
    _, _, frames, cam, proj, _, _ = _render(320, 256, 25.0, 0.0)
    cfg, dec = PatternConfig(**CFG), DecodeConfig()
    ft = torch.from_numpy(frames)
    full = fs.fused_decode_triangulate(ft, cam, proj, cfg, dec)
    half = fs.fused_decode_triangulate(ft[:, 128:].contiguous(), cam, proj, cfg,
                                       dec, row_offset=128.0)
    for a, b in zip(half, full):
        assert torch.equal(a, b[..., 128:, :])


def test_scan_params_carry_the_branch_fields():
    """The parameter block of each branch: frame type, geometry, integer
    thresholds, row and multifreq constants, rounded as the plain version's."""
    from slr_torch.synth.render import default_rig as rig

    cam, proj = rig(cam_w=320, cam_h=256, proj_w=256, proj_h=192,
                    proj_dist=PROJ_DIST)
    dec = DecodeConfig()
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    cfg = PatternConfig(**CFG, row_gray_bits=6, row_phase_steps=3)
    p = fs.scan_params(cam, proj, cfg, dec, (1.0, 1e4), 8, 256, 320,
                       dtype=torch.uint8, row_offset=64.0)
    assert (p.dtype, p.geometry, p.multifreq, p.row_bits, p.row_steps) == (1, 1, 0, 6, 3)
    assert (p.tau_black_i, p.tau_white_i, p.tau_mod) == (26, 5, f32(0.05 * 255))
    assert p.row_offset == 64.0 and p.row_mod_scale == f32(2 / 3)
    assert [p.pfy, p.pcy] == [float(proj.fy), float(proj.cy)]
    assert [p.q1, p.q2, p.s1, p.s2, p.q3] == proj.dist.tolist()
    assert (p.row_pitch, p.h_coded, p.h_fold) == (3.0, 192.0, 191.5)
    assert list(p.row_sin_d[:3]) == [f32(np.sin(2 * np.pi * k / 3)) for k in range(3)]
    mf = PatternConfig(proj_width=256, proj_height=192, coding="multifreq",
                       phase_steps=4, mf_levels=3, mf_ratio=6.0)
    p = fs.scan_params(cam, None, mf, dec, (1.0, 1e4), 8, 256, 320,
                       decode_only=True)
    assert (p.geometry, p.multifreq, p.mf_levels) == (2, 1, 3)
    assert list(p.mf_ratio[:3]) == [0.0, 6.0, 6.0]
    assert (p.mf_period, p.mf_fold) == (256.0, 255.5)
    assert p.mf_xp_scale == f32(256 / 36 / (2 * np.pi))
    h = fs.scan_params(cam, proj, PatternConfig(**CFG), dec, (1.0, 1e4), 8, 256,
                       320, dtype=torch.uint16, bit_depth=12, exposures=3,
                       saturation=0.9, fuse="select")
    assert (h.exposures, h.fuse, h.tau_sat_i) == (3, 1, round(0.9 * 4095))
