"""slr_torch.pipeline.registerfuse (config 4) and the synth it renders with,
against the JAX reference (CPU).

Three scans of ``rocks_scene`` from a moving rig are rendered and decoded by
``slr`` and handed to both packages as numpy arrays; the port's random draws
(the subsample and the RANSAC hypotheses) are replaced by JAX's own, so both
packages align the same points. Tolerances: the scene to float32 rounding
(depth 5e-5 relative, 1e-3 mm on 95 % of the pixels); poses within
1e-4 rad and 2e-2 mm of JAX's (float32 sums in another order through
ICP, projective polish and pose graph), and both within the reference's
ground-truth bounds, 0.5 deg and 2 mm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slr.config as jcfg
import slr.pipeline.registerfuse as jreg
from slr.geom.se3 import so3_exp
from slr.pipeline.reconstruct import reconstruct_scan
from slr.registration.normals import grid_normals
from slr.synth import render as jrender
from slr.synth import scene as jscene
import slr_torch.config as tcfg
import slr_torch.pipeline.registerfuse as treg
from slr_torch.geom.camera import camera_from_numpy
from slr_torch.pipeline.reconstruct import scan_cloud_from_numpy
from slr_torch.registration import features as tfeat
from slr_torch.synth import render as trender
from slr_torch.synth import scene as tscene

torch.set_num_threads(2)

CAM_W, CAM_H = 160, 128
PROJ_W, PROJ_H = 256, 192


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rigs():
    cj, pj = jrender.default_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=PROJ_W, proj_h=PROJ_H,
                                 baseline=150.0, toe_in_deg=14.0)
    return (cj, pj), tuple(camera_from_numpy(jax.tree.map(np.asarray, c)) for c in (cj, pj))


def _pose(s):
    """The reference's config-4 orbit step (``benchmarks/tpu_matrix.py``)."""
    return (np.array(so3_exp(jnp.asarray([0.0, 0.025 * s, 0.008 * s], jnp.float32))),
            np.array([7.0 * s, -3.0 * s, 0.0], np.float32))


def test_move_rig_and_rocks_scene_match_reference():
    (cj, pj), (ct, pt) = _rigs()
    R_m, t_m = _pose(2)
    cj2, pj2 = jrender.move_rig(cj, pj, R_m, t_m)
    ct2, pt2 = trender.move_rig(ct, pt, torch.from_numpy(R_m), torch.from_numpy(t_m))
    for a, b in zip((*cj2, *pj2), (*ct2, *pt2)):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6, atol=1e-4)
    dj = np.asarray(jscene.rocks_scene(cj2, CAM_H, CAM_W))
    dt = _np(tscene.rocks_scene(ct2, CAM_H, CAM_W))
    # near a sphere's silhouette its ray parameter -b - sqrt(b^2 - c)
    # cancels: 5e-5 relative there, 1e-3 mm elsewhere
    np.testing.assert_allclose(dt, dj, rtol=5e-5, atol=0)
    assert (np.abs(dt - dj) > 1e-3).mean() < 0.05
    pl = [(0, 0, 580.0), (0.12, 0.08, -1.0)]
    np.testing.assert_allclose(_np(tscene.plane_depth(ct2, CAM_H, CAM_W, *pl)),
                               np.asarray(jscene.plane_depth(cj2, CAM_H, CAM_W, *pl)),
                               atol=1e-3)
    sp = [(20.0, 5.0, 540.0), 140.0]
    np.testing.assert_allclose(_np(tscene.sphere_depth(ct2, CAM_H, CAM_W, *sp)),
                               np.asarray(jscene.sphere_depth(cj2, CAM_H, CAM_W, *sp)),
                               rtol=5e-5)


def test_render_scan_with_moved_rig_matches_reference():
    """The port's render_scan takes a posed camera: a moved rig renders the
    same frames and world points as the reference."""
    (cj, pj), (ct, pt) = _rigs()
    R_m, t_m = _pose(1)
    cj2, pj2 = jrender.move_rig(cj, pj, R_m, t_m)
    ct2, pt2 = trender.move_rig(ct, pt, torch.from_numpy(R_m), torch.from_numpy(t_m))
    cfg_j = jcfg.PatternConfig(proj_width=PROJ_W, proj_height=PROJ_H, gray_bits=6,
                               phase_steps=4)
    cfg_t = tcfg.PatternConfig(proj_width=PROJ_W, proj_height=PROJ_H, gray_bits=6,
                               phase_steps=4)
    depth = jscene.rocks_scene(cj2, CAM_H, CAM_W)
    sj = jrender.render_scan(cj2, pj2, depth, cfg_j)
    st = trender.render_scan(ct2, pt2, torch.from_numpy(np.asarray(depth)), cfg_t)
    np.testing.assert_allclose(_np(st.points_true), np.asarray(sj.points_true), atol=2e-3)
    agree = _np(st.mask_true) == np.asarray(sj.mask_true)
    assert agree.mean() > 0.999
    # frames: the stripes agree but on pixels whose projector coordinate
    # sits on a stripe edge
    diff = np.abs(_np(st.frames) - np.asarray(sj.frames))
    assert (diff > 1e-3).mean() < 2e-3 and float(np.median(diff)) < 1e-5


@pytest.fixture(scope="module")
def config4():
    """Three scans of the rocks scene, decoded by the reference, and the
    reference's registration of them."""
    (cj, pj), (ct, _) = _rigs()
    cfg = jcfg.PatternConfig(proj_width=PROJ_W, proj_height=PROJ_H, gray_bits=6,
                             phase_steps=4)
    clouds, poses = [], []
    for s in range(3):
        R_m, t_m = _pose(s)
        cj2, pj2 = jrender.move_rig(cj, pj, R_m, t_m)
        scan = jrender.render_scan(cj2, pj2, jscene.rocks_scene(cj2, CAM_H, CAM_W), cfg,
                                   noise_std=0.003, key=jax.random.PRNGKey(40 + s))
        clouds.append(jax.tree.map(np.asarray, reconstruct_scan(scan.frames, cj, pj, cfg)))
        poses.append((R_m, t_m))
    rc_j = jcfg.RegistrationConfig(icp_sample_points=1024, ransac_iters=64, icp_iters=10,
                                   pg_iters=10)
    reg_j = jreg.register_scans([jax.tree.map(jnp.asarray, c) for c in clouds], rc_j,
                                use_features=True, cam=cj, loop_closures=True)
    # the reference's subsample probabilities, per seed (= scan index)
    probs = []
    for c in clouds:
        n = np.asarray(grid_normals(jnp.asarray(c.points), jnp.asarray(c.mask)))
        vdir = c.points / (np.linalg.norm(c.points, axis=-1, keepdims=True) + 1e-9)
        good = c.mask & (np.abs(np.sum(n * vdir, -1)) > 0.35)
        p = jnp.asarray(good.reshape(-1), jnp.float32)
        probs.append(p / jnp.sum(p))
    return clouds, poses, reg_j, probs, ct


def _pose_errors(R, t, poses):
    out = []
    for s, (R_m, t_m) in enumerate(poses):
        c = np.clip((np.trace(_np(R[s]).T @ R_m) - 1) / 2, -1, 1)
        out.append((np.degrees(np.arccos(c)), float(np.linalg.norm(_np(t[s]) - t_m))))
    return out


def test_register_scans_matches_reference(config4, monkeypatch):
    clouds, poses, reg_j, probs, cam = config4

    def jax_samples(p, n, seed):
        idx = jax.random.choice(jax.random.PRNGKey(seed), p.shape[0], shape=(n,),
                                p=probs[seed])
        return torch.from_numpy(np.asarray(idx, np.int64))

    def jax_hypotheses(p, n_iters, generator=None):
        keys = jax.random.split(jax.random.PRNGKey(0), n_iters)
        pj = jnp.asarray(_np(p))
        sel = jax.vmap(lambda k: jax.random.choice(k, pj.shape[0], shape=(3,), p=pj))(keys)
        return torch.from_numpy(np.asarray(sel, np.int64))

    monkeypatch.setattr(treg, "_draw_samples", jax_samples)
    monkeypatch.setattr(tfeat, "_draw_hypotheses", jax_hypotheses)
    rc = tcfg.RegistrationConfig(icp_sample_points=1024, ransac_iters=64, icp_iters=10,
                                 pg_iters=10)
    reg_t = treg.register_scans([scan_cloud_from_numpy(*c) for c in clouds], rc,
                                use_features=True, cam=cam, loop_closures=True)
    assert tuple(reg_t.R.shape) == (3, 3, 3) and tuple(reg_t.icp_rms.shape) == (2,)
    np.testing.assert_allclose(_np(reg_t.R), np.asarray(reg_j.R), atol=1e-4)
    np.testing.assert_allclose(_np(reg_t.t), np.asarray(reg_j.t), atol=2e-2)
    np.testing.assert_allclose(_np(reg_t.icp_rms), np.asarray(reg_j.icp_rms), rtol=1e-2)
    for (rt, tt), (rj, tj) in zip(_pose_errors(reg_t.R, reg_t.t, poses),
                                  _pose_errors(reg_j.R, reg_j.t, poses)):
        assert rt < 0.5 and tt < 2.0 and rj < 0.5 and tj < 2.0, (rt, tt, rj, tj)


def test_register_scans_own_draws_recover_poses(config4):
    """The port's own torch.Generator draws, chain only, no camera: the
    exact-NN ICP alone holds the ground-truth bounds."""
    clouds, poses, _, _, _ = config4
    rc = tcfg.RegistrationConfig(icp_sample_points=1024, icp_iters=15, pg_iters=10)
    reg = treg.register_scans([scan_cloud_from_numpy(*c) for c in clouds], rc,
                              use_features=False, loop_closures=False)
    for rot, tr in _pose_errors(reg.R, reg.t, poses):
        assert rot < 0.5 and tr < 2.0, (rot, tr)
    assert float(reg.pg_rms) < 1e-3     # a chain is exactly determined


def test_scan_cloud_from_numpy_and_subsample(config4):
    clouds, _, _, _, _ = config4
    c = scan_cloud_from_numpy(*clouds[0])
    assert c.points.dtype == torch.float32 and c.mask.dtype == torch.bool
    assert np.array_equal(_np(c.mask), clouds[0].mask)
    pts, nrm = treg._subsample(c, 512, seed=3)
    assert tuple(pts.shape) == (512, 3) and tuple(nrm.shape) == (512, 3)
    # every draw is a masked pixel facing the camera
    assert bool((pts[:, 2] > 100).all())
    np.testing.assert_allclose(_np(torch.linalg.norm(nrm, dim=1)), 1.0, atol=1e-5)
    again, _ = treg._subsample(c, 512, seed=3)
    assert torch.equal(pts, again)
