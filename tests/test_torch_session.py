"""slr_torch.pipeline.Session against slr.pipeline.Session (CPU).

A session directory written by the reference (config, calibration, scans)
is opened by the port on the CPU, and the reverse. On every route of
``reconstruct`` the port's session gives the bits of the port's direct call
(the same function with the session's own arguments), and its cloud is held
to the reference's session cloud as the direct calls are held to each
other: masks agreeing on all but 1e-3 of the pixels (on the spatial
routes the port's mask is its unrepaired mask, a subset of the reference's
grown one; ROADMAP §3), x_p within 1e-3 px on all but 1e-4 of the pixels
valid in both, and there the points within rtol 1e-5 / atol 1e-5; the
two-camera route to tests/test_torch_twocam.py's tolerance (cells agreeing
on 99.9 %, points within 1e-3 mm on 99.5 % of the common cells, all
within 5e-3 mm). The
scans are rendered by ``slr.synth`` on a 256x160 camera (spheres scene,
noise 0.005) and a 256x192 two-camera rig. Registration runs on three
160x128 scans of the rocks scene with the reference's draws substituted for
the port's, as tests/test_torch_registerfuse.py does: R within 1e-4, t
within 2e-2 mm, ICP rms within 1e-2 relative.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slr.config as jcfg
import slr.pipeline as jpipe
import slr_torch.config as tcfg
from slr.synth import render as jrender
from slr.synth import scene as jscene
from slr_torch.geom.camera import camera_from_numpy
from slr_torch.io import load_stage, read_ply
from slr_torch.pipeline import Session
from slr_torch.pipeline import reconstruct as trec
from slr_torch.pipeline import registerfuse as treg
from slr_torch.pipeline import tsdf as ttsdf
from slr_torch.pipeline.twocam import reconstruct_two_camera
from slr_torch.registration.filters import statistical_outlier_removal

torch.set_num_threads(2)

W, H = 256, 160
PATTERN = dict(proj_width=256, proj_height=192, gray_bits=6, phase_steps=4)
RIG = dict(cam_w=W, cam_h=H, proj_w=256, proj_h=192, baseline=150.0, toe_in_deg=14.0)
TWO_PATTERN = dict(proj_width=256, proj_height=192, gray_bits=5, row_gray_bits=5,
                   phase_steps=3, row_phase_steps=3)
TWO_W, TWO_H = 256, 192
GAINS = (0.3, 1.0, 3.2)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _port_cam(c):
    return camera_from_numpy(jax.tree.map(np.asarray, c))


@pytest.fixture(scope="module")
def scene():
    """JAX's render of the spheres scene (noise 0.005) as float32 and
    uint8 stacks and a 3-exposure uint8 bracket; a two-camera pair with
    cast shadows; the rigs in both packages."""
    cj, pj = jrender.default_rig(**RIG)
    scan = jrender.render_scan(cj, pj, jscene.spheres_scene(cj, H, W),
                               jcfg.PatternConfig(**PATTERN), noise_std=0.005,
                               key=jax.random.PRNGKey(0))
    f32 = np.array(scan.frames)
    clean = np.array(jrender.render_scan(cj, pj, jscene.spheres_scene(cj, H, W),
                                         jcfg.PatternConfig(**PATTERN)).frames)
    rng = np.random.default_rng(3)
    bracket = np.stack([np.clip(clean * g + 0.003 * rng.standard_normal(clean.shape), 0, 1)
                        for g in GAINS])
    bracket = np.clip(np.round(bracket * 255), 0, 255).astype(np.uint8)
    c1, c2, p2 = jrender.two_camera_rig(cam_w=TWO_W, cam_h=TWO_H, proj_w=256, proj_h=192)
    tcfg_j = jcfg.PatternConfig(**TWO_PATTERN)
    pair = [np.array(jrender.render_scan(c, p2, jscene.spheres_scene(c, TWO_H, TWO_W), tcfg_j,
                                         noise_std=0.003, key=jax.random.PRNGKey(i),
                                         cast_shadows=True).frames)
            for i, c in enumerate((c1, c2))]
    return dict(cams=(cj, pj), frames={"float32": f32,
                                       "uint8": np.round(f32 * 255).astype(np.uint8),
                                       "bracket": bracket},
                two=(c1, c2, p2), pair=pair)


# route: (ScanConfig overrides, reconstruct kwargs, stack)
ROUTES = {
    "fused": ({}, {}, "float32"),
    "fused_uint8": ({}, {}, "uint8"),
    "voting": ({}, dict(spatial_iters=4), "float32"),
    "wavefront": (dict(decode=dict(spatial_unwrap_mode="wavefront")),
                  dict(spatial_iters=4), "float32"),
    "hdr": ({}, {}, "bracket"),
    "scan": ({}, dict(fused=False), "float32"),
    "checked": (dict(reconstruct=dict(checked=True)), {}, "float32"),
    "sor": (dict(reconstruct=dict(sor_k=6, sor_voxel=3.0)), {}, "float32"),
    "accumulate": ({}, dict(accumulate=True), "float32"),
}


def _configs(overrides, pattern=PATTERN, w=W, h=H):
    def build(mod):
        return mod.ScanConfig(
            pattern=mod.PatternConfig(**pattern),
            decode=mod.DecodeConfig(**overrides.get("decode", {})),
            reconstruct=mod.ReconstructConfig(**overrides.get("reconstruct", {})),
            dist=mod.DistConfig(**overrides.get("dist", {})),
            cam_width=w, cam_height=h)

    return build(jcfg), build(tcfg)


def _direct(route, frames, cam, proj, cfg: tcfg.ScanConfig, kw):
    """The port's direct call with the session's own arguments."""
    ft = torch.from_numpy(frames)
    p, d, r = cfg.pattern, cfg.decode, cfg.reconstruct
    if route == "hdr":
        return trec.reconstruct_scan_hdr(ft, cam, proj, p, d, r)
    if route == "scan":
        return trec.reconstruct_scan(ft, cam, proj, p, d, r)
    cloud = trec.reconstruct_dense(ft, cam, proj, p, d, r,
                                   spatial_iters=kw.get("spatial_iters", 0),
                                   spatial_mode=d.spatial_unwrap_mode)
    if route == "sor":
        keep = statistical_outlier_removal(cloud.points.reshape(-1, 3),
                                           cloud.mask.reshape(-1), r.sor_voxel, k=r.sor_k,
                                           std_ratio=r.sor_std_ratio).reshape(H, W)
        cloud = cloud._replace(mask=cloud.mask & keep)
    return cloud


def _bits_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _session_agrees(cj, ct, spatial=False):
    """The port's session cloud against the reference's (module docstring)."""
    mj, mt = np.asarray(cj.mask), _np(ct.mask)
    assert mt.dtype == bool and mt.shape == mj.shape
    if spatial:
        assert not (mt & ~mj).any()
    else:
        assert (mj != mt).mean() <= 1e-3
    both = mj & mt
    assert both.mean() > 0.3
    dx = np.abs(np.asarray(cj.x_p) - _np(ct.x_p))
    assert (dx[both] > 1e-3).mean() <= 1e-4
    agree = both & (dx <= 1e-3)
    np.testing.assert_allclose(_np(ct.points)[agree], np.asarray(cj.points)[agree],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ct.quality), np.asarray(cj.quality), atol=1e-5)
    np.testing.assert_allclose(_np(ct.colors), np.asarray(cj.colors), atol=1e-6)


@pytest.mark.parametrize("route", list(ROUTES))
def test_session_routes_match_direct_call_and_reference(scene, tmp_path, route):
    """The reference's session writes the directory; the port opens it,
    reconstructs on the CPU, and equals its direct call bit for bit and the
    reference's session cloud within the stated tolerance."""
    overrides, kw, kind = ROUTES[route]
    frames = scene["frames"][kind]
    cfg_j, cfg_t = _configs(overrides)
    root = tmp_path / "s"
    js = jpipe.Session(root, cfg_j)
    js.set_calibration(*scene["cams"])
    js.add_scan(frames)
    cj = jax.tree.map(np.asarray, js.reconstruct(0, **kw))
    acc_j = load_stage(root / "clouds" / "scan_000.npz")
    ts = Session(root, device="cpu")
    assert ts.config == cfg_t
    ct = ts.reconstruct(0, **kw)
    cam, proj = (_port_cam(c) for c in scene["cams"])
    _bits_equal(ct, _direct(route, frames, cam, proj, cfg_t, kw))
    _session_agrees(cj, ct, spatial="spatial_iters" in kw)
    # the stage file holds the returned cloud, and loads back the same bits
    _bits_equal(ts.load_cloud(0), ct)
    if route == "accumulate":
        d = load_stage(root / "clouds" / "scan_000.npz")
        acc = trec.accumulate_by_projector(ct, PATTERN["proj_width"])
        for k, v in zip(("acc_points", "acc_mask", "acc_colors"), acc):
            np.testing.assert_array_equal(d[k], _np(v))
        np.testing.assert_array_equal(d["acc_mask"], acc_j["acc_mask"])
        np.testing.assert_allclose(d["acc_points"], acc_j["acc_points"], rtol=1e-5, atol=1e-5)
    if route == "sor":
        assert 0 < int((~ct.mask & trec.reconstruct_dense(
            torch.from_numpy(frames), cam, proj, cfg_t.pattern).mask).sum())


def test_session_checked_gate_raises_on_empty_scan(scene, tmp_path):
    cfg_j, cfg_t = _configs(dict(reconstruct=dict(checked=True)))
    ts = Session(tmp_path / "chk", cfg_t, device="cpu")
    ts.set_calibration(*(_port_cam(c) for c in scene["cams"]))
    ts.add_scan(np.zeros_like(scene["frames"]["float32"]))
    with pytest.raises(RuntimeError, match="mask nearly empty"):
        ts.reconstruct(0)


def _two_camera_agreement(a, b):
    from test_torch_twocam import _agreement

    return _agreement(a, b)


def test_session_two_camera_route(scene, tmp_path, capsys):
    """The two-camera route on a directory the reference wrote, the
    reference's mesh_fallback on a pixel-tile layout, and the route-matrix
    error (a bracket with a second camera)."""
    c1, c2, proj = scene["two"]
    f1, f2 = scene["pair"]
    cfg_j, cfg_t = _configs(dict(dist=dict(pixel_tiles=2)), TWO_PATTERN, TWO_W, TWO_H)
    root = tmp_path / "two"
    js = jpipe.Session(root, jcfg.ScanConfig(pattern=cfg_j.pattern, cam_width=TWO_W,
                                             cam_height=TWO_H))
    js.set_calibration(c1, proj, cam2=c2)
    js.add_scan(f1, frames2=f2)
    cj = jax.tree.map(np.asarray, js.reconstruct(0))
    ts = Session(root, cfg_t, device="cpu")
    assert ts.cam2 is not None
    capsys.readouterr()
    ct = ts.reconstruct(0)
    events = [json.loads(line) for line in capsys.readouterr().err.splitlines()]
    assert any(e["event"] == "mesh_fallback" and e["requested"] == 2 and e["available"] == 1
               for e in events)
    direct = reconstruct_two_camera(torch.from_numpy(f1), torch.from_numpy(f2),
                                    _port_cam(c1), _port_cam(c2), cfg_t.pattern,
                                    cfg_t.decode, cfg_t.reconstruct)
    _bits_equal(ct, direct)
    # the direct calls' tolerance (tests/test_torch_twocam.py)
    agree, d = _two_camera_agreement(cj, ct)
    assert agree >= 0.999 and _np(ct.mask).mean() > 0.4
    assert np.percentile(d, 99.5) <= 1e-3 and d.max() <= 5e-3
    # a bracket with a second camera is refused, in both packages
    bad = tmp_path / "bad"
    js = jpipe.Session(bad, jcfg.ScanConfig(pattern=cfg_j.pattern))
    js.set_calibration(c1, proj, cam2=c2)
    js.add_scan(np.stack([f1, f1 * 0.5]), frames2=f2)
    with pytest.raises(ValueError, match="HDR"):
        js.reconstruct(0)
    with pytest.raises(ValueError, match="HDR"):
        Session(bad, device="cpu").reconstruct(0)


def test_session_opened_by_reference(scene, tmp_path):
    """A directory the port wrote (config, calibration, a uint8 scan and
    its cloud) opens in the reference to the same arrays."""
    _, cfg_t = _configs(dict(reconstruct=dict(sor_k=4)))
    root = tmp_path / "p"
    ts = Session(root, cfg_t, device="cpu")
    cam, proj = (_port_cam(c) for c in scene["cams"])
    ts.set_calibration(cam, proj, {"rms": 0.25})
    ts.add_scan(torch.from_numpy(scene["frames"]["uint8"]))
    ct = ts.reconstruct(0)
    js = jpipe.Session(root)
    assert js.config == _configs(dict(reconstruct=dict(sor_k=4)))[0]
    assert js.calib_meta == {"rms": 0.25} and js.cam2 is None
    for a, b in zip((*js.cam, *js.proj), (*cam, *proj)):
        np.testing.assert_array_equal(np.asarray(a), _np(b))
    s = js.load_scan(0)
    assert s.dtype == jnp.uint8
    np.testing.assert_array_equal(np.asarray(s), scene["frames"]["uint8"])
    for a, b in zip(js.load_cloud(0), ct):
        np.testing.assert_array_equal(np.asarray(a), _np(b))


def test_session_opens_reference_scans_with_their_dtype(scene, tmp_path):
    root = tmp_path / "j"
    js = jpipe.Session(root, _configs({})[0])
    js.set_calibration(*scene["cams"])
    js.add_scan(scene["frames"]["uint8"])
    js.add_scan(scene["frames"]["bracket"])
    ts = Session(root, device="cpu")
    assert ts.load_scan(0).dtype == torch.uint8 and ts.load_scan(1).dim() == 4
    np.testing.assert_array_equal(_np(ts.load_scan(1)), scene["frames"]["bracket"])
    for a, b in zip((*js.cam, *js.proj), (*ts.cam, *ts.proj)):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
        assert b.device.type == "cpu"


def test_reconstruct_all_equals_reconstruct(scene, tmp_path):
    """One batch through ``batched_reconstruct``: each scan's stage file is
    the per-scan call's bits."""
    _, cfg_t = _configs({})
    ts = Session(tmp_path / "all", cfg_t, device="cpu")
    ts.set_calibration(*(_port_cam(c) for c in scene["cams"]))
    f = scene["frames"]["float32"]
    for k in range(3):
        ts.add_scan(np.roll(f, 7 * k, axis=2))
    assert ts.reconstruct_all() == 3
    batch = [ts.load_cloud(i) for i in range(3)]
    for i in range(3):
        _bits_equal(batch[i], ts.reconstruct(i))


def test_session_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(tmp_path / "s")


# ------------------------------------------------- registration and fusion

ORBIT_W, ORBIT_H = 160, 128
REG = dict(icp_sample_points=1024, ransac_iters=64, icp_iters=10, pg_iters=10)


@pytest.fixture(scope="module")
def orbit(tmp_path_factory):
    """Three rocks-scene scans of a moving rig in a reference session,
    reconstructed and registered there; the reference's subsample
    probabilities of its clouds."""
    from slr.geom.se3 import so3_exp
    from slr.registration.normals import grid_normals

    cj, pj = jrender.default_rig(cam_w=ORBIT_W, cam_h=ORBIT_H, proj_w=256, proj_h=192,
                                 baseline=150.0, toe_in_deg=14.0)
    cfg = jcfg.ScanConfig(pattern=jcfg.PatternConfig(**PATTERN),
                          registration=jcfg.RegistrationConfig(**REG),
                          cam_width=ORBIT_W, cam_height=ORBIT_H)
    root = tmp_path_factory.mktemp("orbit") / "s"
    js = jpipe.Session(root, cfg)
    js.set_calibration(cj, pj)
    for s in range(3):
        R_m = so3_exp(jnp.asarray([0.0, 0.025 * s, 0.008 * s], jnp.float32))
        cj2, pj2 = jrender.move_rig(cj, pj, R_m, jnp.asarray([7.0 * s, -3.0 * s, 0.0]))
        js.add_scan(jrender.render_scan(cj2, pj2, jscene.rocks_scene(cj2, ORBIT_H, ORBIT_W),
                                        cfg.pattern, noise_std=0.003,
                                        key=jax.random.PRNGKey(40 + s)).frames)
    js.reconstruct_all()
    reg_j = jax.tree.map(np.asarray, js.register())
    probs = []
    for i in range(3):
        c = jax.tree.map(np.asarray, js.load_cloud(i))
        n = np.asarray(grid_normals(jnp.asarray(c.points), jnp.asarray(c.mask)))
        vdir = c.points / (np.linalg.norm(c.points, axis=-1, keepdims=True) + 1e-9)
        good = c.mask & (np.abs(np.sum(n * vdir, -1)) > 0.35)
        p = jnp.asarray(good.reshape(-1), jnp.float32)
        probs.append(p / jnp.sum(p))
    return root, reg_j, probs


def test_session_register_matches_reference(orbit, tmp_path, monkeypatch):
    from test_torch_registerfuse import _jax_draws

    root, reg_j, probs = orbit
    _jax_draws(monkeypatch, probs)
    shutil.copytree(root, tmp_path / "s")
    ts = Session(tmp_path / "s", device="cpu")
    reg = ts.register()
    np.testing.assert_allclose(_np(reg.R), reg_j.R, atol=1e-4)
    np.testing.assert_allclose(_np(reg.t), reg_j.t, atol=2e-2)
    np.testing.assert_allclose(_np(reg.icp_rms), reg_j.icp_rms, rtol=1e-2)
    _bits_equal(ts.load_registration(), reg)
    # the reference reads the port's registration file
    d = jpipe.Session(tmp_path / "s").load_registration()
    np.testing.assert_array_equal(np.asarray(d.R), _np(reg.R))


def test_session_fuse_files_equal_direct_calls(orbit, tmp_path):
    """``fuse`` and ``fuse_mesh`` write the bytes of the direct calls on
    the session's clouds and poses."""
    from slr_torch.io import write_ply

    root = orbit[0]
    shutil.copytree(root, tmp_path / "s")
    ts = Session(tmp_path / "s", device="cpu")
    reg = ts.register()
    out = ts.fuse(capacity=1 << 16)
    clouds = [ts.load_cloud(i) for i in range(3)]
    pts, val, col, _ = treg.fuse_scans(clouds, reg, ts.config.registration, capacity=1 << 16)
    write_ply(tmp_path / "direct.ply", pts, mask=val, colors=col.expand(-1, 3))
    assert open(out, "rb").read() == (tmp_path / "direct.ply").read_bytes()
    assert read_ply(out)[0].shape[0] > 1000
    mesh = ts.fuse_mesh(voxel=14.0, size_vox=(40, 40, 40))
    vol = ttsdf.fuse_tsdf(clouds, ts.cam, reg.R, reg.t, size_vox=(40, 40, 40), voxel=14.0)
    nv, nf = ttsdf.write_tsdf_mesh_obj(tmp_path / "direct.obj", vol)
    assert nf > 100
    assert open(mesh, "rb").read() == (tmp_path / "direct.obj").read_bytes()
