"""slr_torch fused scan (K1) against the JAX reference kernel (CPU).

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
    before = fs.fused_decode_triangulate.launches
    a = fs.fused_decode_triangulate(ft, cam, proj, cfg, dec)
    b = fs.fused_decode_triangulate_reference(ft, cam, proj, cfg, dec)
    assert fs.fused_decode_triangulate.launches == before  # no kernel launch
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fs.launch_fused_scan(ft, fs.scan_params(cam, proj, cfg, dec, (1.0, 1e4),
                                                8, 128, 160))


def _bad(kind, cam, proj):
    cfg = PatternConfig(**CFG)
    if kind == "row_gray_bits":
        cfg = PatternConfig(**CFG, row_gray_bits=4)
    elif kind == "multifreq":
        cfg = PatternConfig(proj_width=256, proj_height=192, coding="multifreq")
    elif kind == "phase_steps=0":
        cfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=6,
                            phase_steps=0)
    elif kind == "no_inverse":
        cfg = PatternConfig(**CFG, use_inverse=False)
    dtype = torch.uint8 if kind == "uint8" else torch.float32
    frames = torch.zeros((cfg.num_frames, 8, 8), dtype=dtype)
    if kind == "R!=I":
        cam = cam._replace(R=proj.R)
    if kind == "t!=0":
        cam = cam._replace(t=torch.tensor([0.0, 1.0, 0.0]))
    return frames, cam, cfg


@pytest.mark.parametrize("kind,exc,match", [
    ("row_gray_bits", NotImplementedError, "slice 2"),
    ("multifreq", NotImplementedError, "slice 2"),
    ("phase_steps=0", NotImplementedError, "slice 2"),
    ("no_inverse", NotImplementedError, "slice 2"),
    ("uint8", NotImplementedError, "slice 2"),
    ("R!=I", ValueError, "world origin"),
    ("t!=0", ValueError, "world origin"),
])
def test_wrapper_and_plain_version_refuse_outside_contract(kind, exc, match):
    from slr_torch.synth.render import default_rig as rig

    cam, proj = rig(cam_w=8, cam_h=8, proj_w=256, proj_h=192)
    frames, cam, cfg = _bad(kind, cam, proj)
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
