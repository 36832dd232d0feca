"""slr_torch.pipeline.twocam and the synth it renders with, against the JAX
reference (CPU).

Both cameras of a 256x192 two-camera rig (256x192 projector, 5 + 5 Gray
bits, 3-step phase on both axes, cast shadows, noise 0.003) are rendered by
``slr.synth`` and handed to both packages as numpy arrays. JAX's crossing
kernel runs in interpret mode (its route rule takes it at this size, as
the port's takes K7's plain version).

Tolerances: from the same decoded maps, ``invert_to_projector`` and the
triangulation equal JAX's bit for bit (both round the crossing terms as
XLA's FMAs). End to end, the two decoders differ by up to 1 ulp of x_p
(3e-5 px), which the crossings divide by code steps down to 0.125 and the
triangulation multiplies into millimetres: the masks agree on >= 99.9 % of
the cells and the points within 1e-3 mm on 99.5 % of the cells valid in
both (all within 5e-3 mm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slr.config as jcfg
from slr.codec import decode_stack as jax_decode_stack
from slr.geom.camera import pixel_to_ray as jax_pixel_to_ray
from slr.geom.triangulate import triangulate_midpoint as jax_midpoint
from slr.pipeline import twocam as jtw
from slr.synth import render as jrender
from slr.synth import scene as jscene
import slr_torch.config as tcfg
from slr_torch.geom.camera import camera_from_numpy, pixel_to_ray
from slr_torch.geom.triangulate import _solve3x3, triangulate_midpoint
from slr_torch.pipeline import reconstruct_two_camera
from slr_torch.pipeline import twocam as ttw
from slr_torch.synth import render as trender
from slr_torch.synth import scene as tscene

torch.set_num_threads(2)

CAM_W, CAM_H = 256, 192
PROJ_W, PROJ_H = 256, 192
PATTERN = dict(proj_width=PROJ_W, proj_height=PROJ_H, gray_bits=5, row_gray_bits=5,
               phase_steps=3, row_phase_steps=3)
DEPTHS = dict(min_depth=300.0, max_depth=900.0)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def pair():
    """Both cameras' noisy scans with cast shadows, rendered by slr.synth;
    JAX's cameras and the port's; JAX's clouds, computed once a method."""
    cfg = jcfg.PatternConfig(**PATTERN)
    c1, c2, proj = jrender.two_camera_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=PROJ_W,
                                          proj_h=PROJ_H)
    scans = [jrender.render_scan(c, proj, jscene.spheres_scene(c, CAM_H, CAM_W), cfg,
                                 noise_std=0.003, key=jax.random.PRNGKey(i),
                                 cast_shadows=True) for i, c in enumerate((c1, c2))]
    frames = [np.array(s.frames) for s in scans]
    cams_t = [camera_from_numpy(jax.tree.map(np.asarray, c)) for c in (c1, c2)]
    jax_clouds = {}

    def jax_cloud(method, merge_kernel=True):
        key = (method, merge_kernel)
        if key not in jax_clouds:
            cl = jtw.reconstruct_two_camera(
                jnp.asarray(frames[0]), jnp.asarray(frames[1]), c1, c2, cfg,
                rec=jcfg.ReconstructConfig(**DEPTHS), method=method,
                merge_kernel=merge_kernel)
            jax_clouds[key] = jax.tree.map(np.asarray, cl)
        return jax_clouds[key]

    return dict(cfg=cfg, cams=(c1, c2), proj=proj, scans=scans, frames=frames,
                cams_t=cams_t, jax_cloud=jax_cloud)


def _port_cloud(pair, method, **kw):
    f1, f2 = (torch.from_numpy(f) for f in pair["frames"])
    return reconstruct_two_camera(f1, f2, *pair["cams_t"], tcfg.PatternConfig(**PATTERN),
                                  rec=tcfg.ReconstructConfig(**DEPTHS), method=method, **kw)


def _agreement(a, b):
    """(mask agreement, |dpoints| (mm) on the cells valid in both)."""
    ma, mb = np.asarray(a.mask), _np(b.mask)
    both = ma & mb
    d = np.linalg.norm(np.asarray(a.points) - _np(b.points), axis=-1)[both]
    return float((ma == mb).mean()), d


def _proj_truth(proj, h, w):
    """Ground truth on the projector grid (``tests/test_twocam.py:53-67``):
    the first surface along each projector ray."""
    depth_p = jscene.spheres_scene(proj, h, w)
    v, u = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                        jnp.arange(w, dtype=jnp.float32), indexing="ij")
    o, d = jax_pixel_to_ray(proj, u, v)
    dz = jnp.einsum("j,...j->...", proj.R[2], d)
    return np.asarray(o + (depth_p / dz)[..., None] * d)


# ----------------------------------------------------------------- synth

def test_two_camera_rig_and_spheres_scene_match_reference():
    for (cj, ct) in zip(jrender.two_camera_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=PROJ_W,
                                               proj_h=PROJ_H),
                        trender.two_camera_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=PROJ_W,
                                               proj_h=PROJ_H)):
        for a, b in zip(cj, ct):
            assert b.dtype == torch.float32
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6, atol=1e-4)
    c1, c2, _ = jrender.two_camera_rig(cam_w=CAM_W, cam_h=CAM_H)
    for c in (c1, c2):
        ct = camera_from_numpy(jax.tree.map(np.asarray, c))
        dj = np.asarray(jscene.spheres_scene(c, CAM_H, CAM_W))
        dt = _np(tscene.spheres_scene(ct, CAM_H, CAM_W))
        # near a silhouette the sphere's ray parameter cancels: 5e-5 relative
        np.testing.assert_allclose(dt, dj, rtol=5e-5, atol=0)
        assert (np.abs(dt - dj) > 1e-3).mean() < 0.05


def test_render_with_cast_shadows_matches_reference(pair):
    """Noiseless renders of both cameras from the same depth map: the
    shadow map (a scatter-min), the lit mask and the frames."""
    cfg = pair["cfg"]
    tcfg_ = tcfg.PatternConfig(**PATTERN)
    proj_t = camera_from_numpy(jax.tree.map(np.asarray, pair["proj"]))
    for cj, ct in zip(pair["cams"], pair["cams_t"]):
        depth = jscene.spheres_scene(cj, CAM_H, CAM_W)
        sj = jrender.render_scan(cj, pair["proj"], depth, cfg, cast_shadows=True)
        st = trender.render_scan(ct, proj_t, torch.from_numpy(np.array(depth)), tcfg_,
                                 cast_shadows=True, shadow_bias=2.0)
        lit_j, lit_t = np.asarray(sj.mask_true), _np(st.mask_true)
        unshadowed = jrender.render_scan(cj, pair["proj"], depth, cfg)
        shadowed = np.asarray(unshadowed.mask_true) & ~lit_j
        assert shadowed.sum() > 0.01 * CAM_W * CAM_H        # the spheres cast shadows
        # a point within float rounding of the shadow bias may flip
        assert (lit_j == lit_t).mean() > 0.999
        # the stripes agree but on pixels whose projector coordinate sits
        # on a stripe edge
        diff = np.abs(_np(st.frames) - np.asarray(sj.frames))[:, lit_j == lit_t]
        assert (diff > 1e-3).mean() < 2e-3 and float(np.median(diff)) < 1e-5


# ------------------------------------------------------- merge building blocks

def test_solve3x3_matches_numpy():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(50, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    b = rng.normal(size=(50, 3)).astype(np.float32)
    x = _solve3x3(torch.from_numpy(A), torch.from_numpy(b))
    np.testing.assert_allclose(_np(x), np.linalg.solve(A, b[..., None])[..., 0],
                               rtol=1e-4, atol=1e-5)


def test_code_edge_mask_matches_reference_borders_included():
    rng = np.random.default_rng(2)
    H, W = 37, 53
    v, u = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                       indexing="ij")
    x_p = 0.8 * u + rng.normal(0, 0.3, (H, W)).astype(np.float32)
    y_p = 0.7 * v + rng.normal(0, 0.3, (H, W)).astype(np.float32)
    x_p[10:20, 30:] += 9.0                  # a silhouette
    x_p[0, ::4] += 6.0                      # jumps on every border
    x_p[-1, ::5] -= 6.0
    y_p[::3, 0] += 5.0
    y_p[::4, -1] -= 5.0
    mask = rng.random((H, W)) > 0.15
    for tol in (1.5, 3.0):
        ej = jtw._code_edge_mask(jnp.asarray(x_p), jnp.asarray(y_p), jnp.asarray(mask), tol)
        et = ttw._code_edge_mask(torch.from_numpy(x_p), torch.from_numpy(y_p),
                                 torch.from_numpy(mask), tol)
        np.testing.assert_array_equal(_np(et), np.asarray(ej))
        assert 0.05 < float(et.float().mean()) < 0.95


@pytest.mark.parametrize("flip", ["none", "u", "v"])
def test_invert_to_projector_flip_axes_match_reference(flip):
    """``tests/test_twocam.py:270-305``: mirrored rigs invert to the
    flipped image frame; each variant equals JAX's."""
    H, W, PW, PH = 64, 96, 64, 48
    v, u = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                       indexing="ij")
    x_p = 0.6 * u + 2.0 + 0.01 * v
    y_p = 0.7 * v + 1.0 + 0.005 * u
    if flip == "u":
        x_p, y_p = x_p[:, ::-1].copy(), y_p[:, ::-1].copy()
    elif flip == "v":
        x_p, y_p = x_p[::-1].copy(), y_p[::-1].copy()
    kw = dict(flip_u=flip == "u", flip_v=flip == "v")
    ones = np.ones((H, W), np.float32)
    mj = jtw.invert_to_projector(jnp.asarray(x_p), jnp.asarray(y_p), jnp.ones((H, W), bool),
                                 jnp.asarray(ones), jnp.asarray(ones), PW, PH, **kw)
    mt = ttw.invert_to_projector(torch.from_numpy(x_p), torch.from_numpy(y_p),
                                 torch.ones((H, W), dtype=torch.bool), torch.from_numpy(ones),
                                 torch.from_numpy(ones), PW, PH, **kw)
    for a, b in zip(mj, mt):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    base = ttw.invert_to_projector(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        0.6 * u + 2.0 + 0.01 * v, 0.7 * v + 1.0 + 0.005 * u)),
        torch.ones((H, W), dtype=torch.bool), torch.from_numpy(ones),
        torch.from_numpy(ones), PW, PH)
    valid = _np(base[0])
    assert valid.sum() > 0.5 * PW * PH
    np.testing.assert_array_equal(_np(mt[0]), valid)
    if flip == "u":
        np.testing.assert_allclose((W - 1) - _np(mt[1])[valid], _np(base[1])[valid],
                                   atol=1e-3)
    if flip == "v":
        np.testing.assert_allclose((H - 1) - _np(mt[2])[valid], _np(base[2])[valid],
                                   atol=1e-3)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_invert_and_triangulate_from_the_same_decode_match_reference(pair, use_kernel):
    """The merge after the decode, each package handed JAX's decoded maps:
    the inversions (K7's plain version, or crossing_interp's plain route)
    and the midpoint points equal JAX's (its fused route, or its oracle)
    bit for bit; the oracle's nearest channels, stored in bf16 in each of
    its two passes, within 0.8 % of their largest value."""
    cfg = pair["cfg"]
    maps = []
    for f, cj, ct in zip(pair["frames"], pair["cams"], pair["cams_t"]):
        r = jax_decode_stack(jnp.asarray(f), cfg, jcfg.DecodeConfig())
        ej = jtw._code_edge_mask(r.x_p, r.y_p, r.mask, 3.0)
        mj = jtw.invert_to_projector(r.x_p, r.y_p, r.mask & ej, r.quality,
                                     jnp.asarray(f[0]), PROJ_W, PROJ_H,
                                     use_kernel=use_kernel)
        x_p, y_p, mask, q = (torch.from_numpy(np.array(a)) for a in (
            r.x_p, r.y_p, r.mask, r.quality))
        et = ttw._code_edge_mask(x_p, y_p, mask, 3.0)
        np.testing.assert_array_equal(_np(et), np.asarray(ej))
        mt = ttw.invert_to_projector(x_p, y_p, mask & et, q, torch.from_numpy(f[0].copy()),
                                     PROJ_W, PROJ_H, use_kernel=use_kernel)
        assert _np(mt[0]).sum() > 0.4 * PROJ_W * PROJ_H
        np.testing.assert_array_equal(_np(mt[0]), np.asarray(mj[0]))
        for i, (a, b) in enumerate(zip(mj[1:], mt[1:])):
            tol = 0 if use_kernel or i < 2 else 8e-3 * float(np.abs(np.asarray(a)).max())
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=0, atol=tol)
        maps.append(((cj, mj), (ct, mt)))
    (c1, j1), (t1c, t1) = maps[0]
    (c2, j2), (t2c, t2) = maps[1]
    pj, _ = jax_midpoint(*jax_pixel_to_ray(c1, j1[1], j1[2]), *jax_pixel_to_ray(c2, j2[1], j2[2]))
    pt, _ = triangulate_midpoint(*pixel_to_ray(t1c, t1[1], t1[2]),
                                 *pixel_to_ray(t2c, t2[1], t2[2]))
    valid = np.asarray(j1[0] & j2[0])
    np.testing.assert_array_equal(_np(pt)[valid], np.asarray(pj)[valid])


# ------------------------------------------------------------- end to end

@pytest.mark.parametrize("merge_kernel", [True, False])
def test_merge_matches_reference(pair, merge_kernel):
    """``method="merge"`` end to end (``merge_kernel``: the fused route, K7's
    plain version, or the plain contraction), against JAX's same route and
    the projector-grid ground truth."""
    a = pair["jax_cloud"]("merge", merge_kernel)
    b = _port_cloud(pair, "merge", merge_kernel=merge_kernel)
    assert b.points.shape == (PROJ_H, PROJ_W, 3) and b.mask.shape == (PROJ_H, PROJ_W)
    agree, d = _agreement(a, b)
    assert agree >= 0.999, agree
    assert np.percentile(d, 99.5) <= 1e-3 and d.max() <= 5e-3, (np.percentile(d, 99.5), d.max())
    np.testing.assert_array_equal(_np(b.x_p), np.asarray(a.x_p))
    mask = _np(b.mask)
    err = np.linalg.norm(_np(b.points) - _proj_truth(pair["proj"], PROJ_H, PROJ_W),
                         axis=-1)[mask]
    assert mask.sum() > 0.4 * PROJ_W * PROJ_H
    assert float(np.sqrt((err ** 2).mean())) < 0.1
    assert bool(torch.isfinite(b.points).all())


def _cam1_rms(pair, cloud):
    scan = pair["scans"][0]
    valid = _np(cloud.mask) & np.asarray(scan.mask_true)
    err = np.linalg.norm(_np(cloud.points) - np.asarray(scan.points_true), axis=-1)[valid]
    return float(np.sqrt((err ** 2).mean())), int(valid.sum())


@pytest.mark.parametrize("method", ["splat", "search"])
def test_oracles_match_reference(pair, method):
    """The cam-1-grid oracles against JAX's and the ground truth (< 0.5
    mm, the reference's gate). Splat sums its moments in another order
    (``index_add_`` against XLA's scatter), so its points differ more."""
    a = pair["jax_cloud"](method)
    b = _port_cloud(pair, method)
    assert b.points.shape == (CAM_H, CAM_W, 3)
    agree, d = _agreement(a, b)
    assert agree >= 0.999, agree
    p999, worst = (1e-2, 5e-2) if method == "splat" else (2e-3, 5e-3)
    assert np.percentile(d, 99.9) <= p999 and d.max() <= worst, (np.percentile(d, 99.9), d.max())
    rms, n = _cam1_rms(pair, b)
    assert rms < 0.5 and n > 0.25 * CAM_W * CAM_H, (rms, n)


def test_search_agrees_with_splat(pair):
    """``tests/test_twocam.py:249-267``: search covers most of splat's
    cells, within 0.5 mm at the 95th percentile."""
    s = _port_cloud(pair, "search")
    p = _port_cloud(pair, "splat")
    both = _np(s.mask) & _np(p.mask)
    assert both.sum() > 0.85 * _np(p.mask).sum()
    d = np.linalg.norm(_np(s.points) - _np(p.points), axis=-1)[both]
    assert np.percentile(d, 95) < 0.5


def test_two_camera_requires_row_coding():
    cfg = tcfg.PatternConfig(proj_width=512, proj_height=384, gray_bits=6, phase_steps=3)
    c1, c2, _ = trender.two_camera_rig(cam_w=64, cam_h=64)
    frames = torch.zeros((cfg.num_frames, 64, 64))
    with pytest.raises(ValueError, match="row_gray_bits"):
        reconstruct_two_camera(frames, frames, c1, c2, cfg)
    cfg2 = tcfg.PatternConfig(**PATTERN)
    frames2 = torch.zeros((cfg2.num_frames, 64, 64))
    with pytest.raises(ValueError, match="method"):
        reconstruct_two_camera(frames2, frames2, c1, c2, cfg2, method="bogus")


def test_route_rule_is_the_reference_rule():
    """K7 at config 3 (1280x1024 cameras, 1024x768 projector) and on small
    rigs; the tiled route (K6) on a 2448x2048 sensor, whose one-hot would
    exceed the reference's 8 MiB budget, and past 2560 px."""
    assert ttw.takes_fused(1024, 1280, 1024, 768)
    assert ttw.takes_fused(CAM_H, CAM_W, PROJ_W, PROJ_H)
    assert not ttw.takes_fused(2048, 2448, 1024, 768)
    assert not ttw.takes_fused(100, 2600, 64, 64)
