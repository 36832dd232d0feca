"""slr_torch geometry and config against the JAX reference (CPU).

The same numpy-seeded rays, poses and points go through ``slr.geom`` and
``slr_torch.geom``. Tolerance 1e-5 relative: both are float32 with the
same formulas; only summation order and libm rounding differ.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import slr.config as jcfg
import slr_torch
import slr_torch.config as tcfg
from slr.geom import camera as jcam
from slr.geom import triangulate as jtri
from slr_torch.geom import camera as tcam
from slr_torch.geom import triangulate as ttri

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


def _close(a, b, rtol=RTOL, atol=0.0):
    a = np.asarray(a, np.float64)
    b = b.detach().cpu().numpy().astype(np.float64) if torch.is_tensor(b) else np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


def _rotation(rng, max_angle=0.5):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = rng.uniform(-max_angle, max_angle)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K).astype(np.float32)


def _camera_pair(rng, with_pose=True):
    """The same random camera in both packages (numpy-made fields)."""
    dist = rng.uniform(-0.2, 0.2, 5).astype(np.float32) * np.array(
        [1, 0.5, 0.05, 0.05, 0.1], np.float32)
    R = _rotation(rng) if with_pose else np.eye(3, dtype=np.float32)
    t = rng.uniform(-50, 50, 3).astype(np.float32) if with_pose else np.zeros(3, np.float32)
    args = dict(fx=float(rng.uniform(800, 1400)), fy=float(rng.uniform(800, 1400)),
                cx=float(rng.uniform(300, 700)), cy=float(rng.uniform(200, 500)))
    cj = jcam.make_camera(**args, dist=dist, R=R, t=t)
    ct = tcam.make_camera(**args, dist=dist, R=R, t=t)
    return cj, ct


# ---------------------------------------------------------------- config

@pytest.mark.parametrize("name", ["PatternConfig", "DecodeConfig", "CalibConfig",
                                  "ReconstructConfig", "RegistrationConfig"])
def test_config_fields_match_reference(name):
    a, b = getattr(jcfg, name), getattr(tcfg, name)
    fa = [(f.name, f.default) for f in dataclasses.fields(a)]
    fb = [(f.name, f.default) for f in dataclasses.fields(b)]
    assert fa == fb
    assert a.__dataclass_params__.frozen and b.__dataclass_params__.frozen


@pytest.mark.parametrize("kw", [
    {},
    dict(proj_width=256, proj_height=192, gray_bits=6, phase_steps=4),
    dict(gray_bits=5, row_gray_bits=4, row_phase_steps=3, phase_steps=3),
    dict(phase_steps=0, use_inverse=False),
    dict(coding="multifreq", mf_levels=4, mf_ratio=6.0),
])
def test_pattern_config_properties_match_reference(kw):
    a, b = jcfg.PatternConfig(**kw), tcfg.PatternConfig(**kw)
    for prop in ("fringe_pitch", "row_fringe_pitch", "mf_pitches", "num_frames"):
        assert getattr(a, prop) == getattr(b, prop), prop


@pytest.mark.parametrize("kw", [
    dict(coding="bogus"),
    dict(coding="multifreq", phase_steps=2),
    dict(coding="multifreq", row_gray_bits=3),
    dict(coding="multifreq", mf_levels=0),
    dict(row_phase_steps=3),
])
def test_pattern_config_rejects_like_reference(kw):
    with pytest.raises(ValueError) as ea:
        jcfg.PatternConfig(**kw)
    with pytest.raises(ValueError) as eb:
        tcfg.PatternConfig(**kw)
    assert str(ea.value) == str(eb.value)


def test_full_fp32_flags_after_import():
    assert slr_torch.__name__ == "slr_torch"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_port_imports_neither_jax_nor_slr():
    """The GPU machine has no JAX: the port must import none of it, nor
    anything under ``slr`` (whose __init__ imports jax)."""
    code = (
        "import sys\n"
        "import slr_torch, slr_torch.pipeline.reconstruct, "
        "slr_torch.synth.render, slr_torch.entry, slr_torch.kernels.build, "
        "slr_torch.kernels.unwrap_scan, slr_torch.kernels.wavefront, "
        "slr_torch.kernels.band_nn, slr_torch.geom.se3, slr_torch.registration, "
        "slr_torch.registration.band, slr_torch.registration.features, "
        "slr_torch.registration.icp, slr_torch.registration.posegraph, "
        "slr_torch.registration.projective, slr_torch.registration.voxel, "
        "slr_torch.pipeline.registerfuse, slr_torch.registration.filters, "
        "slr_torch.dist, slr_torch.dist.ba, slr_torch.pipeline.tsdf, "
        "slr_torch.pipeline.meshing, slr_torch.geom.triangulate, "
        "slr_torch.synth.scene, slr_torch.kernels.crossing, slr_torch.pipeline.twocam, "
        "slr_torch.calib, slr_torch.calib.board, slr_torch.calib.homography, "
        "slr_torch.calib.lm, slr_torch.calib.zhang, slr_torch.calib.stereo, "
        "slr_torch.calib.corners, slr_torch.calib.proj_corners, "
        "slr_torch.calib.pipeline, slr_torch.synth.board\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'slr' or m.startswith('slr.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------- camera

def test_make_camera_matches_reference():
    cj = jcam.make_camera(1000.0, 990.5, 320.25, 240.75, dist=[0.1, -0.05, 0.001])
    ct = tcam.make_camera(1000.0, 990.5, 320.25, 240.75, dist=[0.1, -0.05, 0.001])
    for a, b in zip(cj, ct):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    back = tcam.camera_from_numpy(jax.tree.map(np.asarray, cj))
    for a, b in zip(back, ct):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_distort_and_undistort_match_reference(seed):
    rng = np.random.default_rng(seed)
    cj, ct = _camera_pair(rng)
    xn = rng.uniform(-0.5, 0.5, (64, 32)).astype(np.float32)
    yn = rng.uniform(-0.4, 0.4, (64, 32)).astype(np.float32)
    xdj, ydj = jcam.distort(xn, yn, cj.dist)
    xdt, ydt = tcam.distort(torch.from_numpy(xn), torch.from_numpy(yn), ct.dist)
    _close(xdj, xdt, atol=1e-7)
    _close(ydj, ydt, atol=1e-7)
    xuj, yuj = jcam.undistort_iterative(xdj, ydj, cj.dist, 8)
    xut, yut = tcam.undistort_iterative(xdt, ydt, ct.dist, 8)
    _close(xuj, xut, atol=1e-6)
    _close(yuj, yut, atol=1e-6)
    # and the inversion itself holds in the port
    np.testing.assert_allclose(xut.numpy(), xn, atol=2e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_project_and_pixel_to_ray_match_reference(seed):
    rng = np.random.default_rng(seed)
    cj, ct = _camera_pair(rng)
    pts = np.concatenate([rng.uniform(-150, 150, (500, 2)),
                          rng.uniform(300, 700, (500, 1))], 1).astype(np.float32)
    pts_w = (pts - np.asarray(cj.t)) @ np.asarray(cj.R)  # camera -> world
    uvj, zj = jcam.project(cj, pts_w)
    uvt, zt = tcam.project(ct, torch.from_numpy(pts_w))
    _close(uvj, uvt)
    _close(zj, zt)
    u = rng.uniform(0, 1000, (40, 25)).astype(np.float32)
    v = rng.uniform(0, 800, (40, 25)).astype(np.float32)
    oj, dj = jcam.pixel_to_ray(cj, u, v)
    ot, dt = tcam.pixel_to_ray(ct, torch.from_numpy(u), torch.from_numpy(v))
    _close(oj, ot)
    _close(dj, dt, atol=1e-6)


# ---------------------------------------------------------------- triangulate

@pytest.mark.parametrize("seed", [0, 1])
def test_triangulate_midpoint_matches_reference(seed):
    rng = np.random.default_rng(seed)
    o1 = rng.normal(size=3).astype(np.float32)
    o2 = (rng.normal(size=3) + [200, 0, 0]).astype(np.float32)
    X = np.concatenate([rng.uniform(-100, 100, (300, 2)),
                        rng.uniform(400, 600, (300, 1))], 1).astype(np.float32)
    d1 = X - o1 + rng.normal(0, 0.1, X.shape)
    d2 = X - o2 + rng.normal(0, 0.1, X.shape)
    d1 = (d1 / np.linalg.norm(d1, axis=-1, keepdims=True)).astype(np.float32)
    d2 = (d2 / np.linalg.norm(d2, axis=-1, keepdims=True)).astype(np.float32)
    mj, gj = jtri.triangulate_midpoint(o1, d1, o2, d2)
    mt, gt = ttri.triangulate_midpoint(*(torch.from_numpy(a) for a in (o1, d1, o2, d2)))
    _close(mj, mt, atol=1e-3)  # 1e-5 relative of ~500 mm coordinates
    _close(gj, gt, atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_triangulate_plane_and_rays_match_reference(seed):
    rng = np.random.default_rng(seed)
    camj, camt = _camera_pair(rng, with_pose=seed == 1)
    projj, projt = _camera_pair(rng)
    u = rng.uniform(0, 1000, (30, 20)).astype(np.float32)
    v = rng.uniform(0, 800, (30, 20)).astype(np.float32)
    x_p = rng.uniform(0, 1000, (30, 20)).astype(np.float32)
    y_p = rng.uniform(0, 700, (30, 20)).astype(np.float32)
    tt = [torch.from_numpy(a) for a in (u, v, x_p, y_p)]
    pj, zj = jtri.triangulate_plane(camj, projj, u, v, x_p)
    pt, zt = ttri.triangulate_plane(camt, projt, *tt[:3])
    ok = np.abs(np.asarray(zj)) < 1e4  # rays nearly parallel to a plane are ill-posed
    assert ok.mean() > 0.5
    _close(np.asarray(pj)[ok], pt.numpy()[ok], rtol=1e-4, atol=1e-3)
    _close(np.asarray(zj)[ok], zt.numpy()[ok], rtol=1e-4, atol=1e-3)
    mj, gj = jtri.triangulate_rays(camj, projj, u, v, x_p, y_p)
    mt, gt = ttri.triangulate_rays(camt, projt, *tt)
    _close(mj, mt, rtol=1e-4, atol=1e-3)
    _close(gj, gt, rtol=1e-4, atol=1e-3)


def test_triangulate_dlt_matches_reference():
    """tests/test_geom.py's rig case: 400 numpy-seeded points seen by the
    default rig, DLT from the camera pixel and the projector column (and
    row). The closed-form 3x3 solve amplifies float32 rounding by the
    normal equations' conditioning: within 2e-2 mm of JAX's, and both
    within the reference's 5e-2 mm of the truth."""
    from slr.synth.render import default_rig

    cj, pj = default_rig()
    ct, pt = (tcam.camera_from_numpy(jax.tree.map(np.asarray, c)) for c in (cj, pj))
    rng = np.random.default_rng(6)
    pts = np.stack([rng.uniform(-60, 60, 400), rng.uniform(-50, 50, 400),
                    rng.uniform(420, 600, 400)], axis=1).astype(np.float32)
    uv_c = np.asarray(jcam.project(cj, pts)[0])
    uv_p = np.asarray(jcam.project(pj, pts)[0])
    for rows in (False, True):
        vp = uv_p[:, 1] if rows else None
        xj = np.asarray(jtri.triangulate_dlt(cj, pj, uv_c[:, 0], uv_c[:, 1], uv_p[:, 0], vp))
        xt = ttri.triangulate_dlt(ct, pt, *(torch.from_numpy(a) for a in (
            uv_c[:, 0], uv_c[:, 1], uv_p[:, 0])), None if vp is None else torch.from_numpy(vp))
        assert tuple(xt.shape) == (400, 3)
        np.testing.assert_allclose(xt.numpy(), xj, atol=2e-2)
        assert np.linalg.norm(xt.numpy() - pts, axis=-1).max() < 5e-2
        assert np.linalg.norm(xj - pts, axis=-1).max() < 5e-2


def test_camera_to_and_center():
    cj, ct = _camera_pair(np.random.default_rng(0))
    moved = ct.to("cpu")
    assert isinstance(moved, tcam.Camera)
    assert all(torch.equal(a, b) for a, b in zip(moved, ct))
    _close(cj.center, ct.center, atol=1e-4)
