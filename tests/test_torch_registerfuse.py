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
    clouds, poses, truths = [], [], []
    for s in range(3):
        R_m, t_m = _pose(s)
        cj2, pj2 = jrender.move_rig(cj, pj, R_m, t_m)
        scan = jrender.render_scan(cj2, pj2, jscene.rocks_scene(cj2, CAM_H, CAM_W), cfg,
                                   noise_std=0.003, key=jax.random.PRNGKey(40 + s))
        clouds.append(jax.tree.map(np.asarray, reconstruct_scan(scan.frames, cj, pj, cfg)))
        poses.append((R_m, t_m))
        truths.append(np.asarray(scan.points_true)[np.asarray(scan.mask_true)])
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
    return clouds, poses, reg_j, probs, ct, truths


def _pose_errors(R, t, poses):
    out = []
    for s, (R_m, t_m) in enumerate(poses):
        c = np.clip((np.trace(_np(R[s]).T @ R_m) - 1) / 2, -1, 1)
        out.append((np.degrees(np.arccos(c)), float(np.linalg.norm(_np(t[s]) - t_m))))
    return out


def _jax_draws(monkeypatch, probs):
    """Replace the port's draws by the reference's: the subsample of scan s
    (seed s, or 100 + s for BA's landmarks) and the RANSAC hypotheses (key
    0 for every pair, as the reference's vmapped RANSAC draws too)."""
    def jax_samples(p, n, seed):
        idx = jax.random.choice(jax.random.PRNGKey(seed), p.shape[0], shape=(n,),
                                p=probs[seed % 100])
        return torch.from_numpy(np.asarray(idx, np.int64))

    def jax_hypotheses(p, n_iters, generator=None):
        keys = jax.random.split(jax.random.PRNGKey(0), n_iters)
        pj = jnp.asarray(_np(p))
        sel = jax.vmap(lambda k: jax.random.choice(k, pj.shape[0], shape=(3,), p=pj))(keys)
        return torch.from_numpy(np.asarray(sel, np.int64))

    monkeypatch.setattr(treg, "_draw_samples", jax_samples)
    monkeypatch.setattr(tfeat, "_draw_hypotheses", jax_hypotheses)


def test_register_scans_matches_reference(config4, monkeypatch):
    clouds, poses, reg_j, probs, cam, _ = config4
    _jax_draws(monkeypatch, probs)
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
    clouds, poses, _, _, _, _ = config4
    rc = tcfg.RegistrationConfig(icp_sample_points=1024, icp_iters=15, pg_iters=10)
    reg = treg.register_scans([scan_cloud_from_numpy(*c) for c in clouds], rc,
                              use_features=False, loop_closures=False)
    for rot, tr in _pose_errors(reg.R, reg.t, poses):
        assert rot < 0.5 and tr < 2.0, (rot, tr)
    assert float(reg.pg_rms) < 1e-3     # a chain is exactly determined


def test_scan_cloud_from_numpy_and_subsample(config4):
    clouds, _, _, _, _, _ = config4
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


RC5 = dict(icp_sample_points=1024, ransac_iters=64, icp_iters=10, pg_iters=10)
BA5 = dict(n_landmarks=128, iters=4)


@pytest.fixture(scope="module")
def config5(config4):
    """The reference's config 5 on the three scans: batched registration,
    BA from it, the fused cloud from BA's poses."""
    from slr.geom.camera import Camera as JCamera

    clouds, _, _, _, ct, _ = config4
    jc = [jax.tree.map(jnp.asarray, c) for c in clouds]
    cam_j = JCamera(*(jnp.asarray(x.numpy()) for x in ct))
    reg_b = jreg.register_scans_batched(jc, jcfg.RegistrationConfig(**RC5), use_features=True,
                                        cam=cam_j)
    reg_ba = jreg.ba_refine(jc, reg_b, **BA5)
    fused = jreg.fuse_scans(jc, reg_ba, jcfg.RegistrationConfig(voxel_size=2.0),
                            capacity=1 << 16)
    return tuple(jax.tree.map(np.asarray, x) for x in (reg_b, reg_ba, fused))


def test_register_scans_batched_matches_reference(config4, config5, monkeypatch):
    clouds, poses, _, probs, cam, _ = config4
    reg_j = config5[0]
    _jax_draws(monkeypatch, probs)
    reg_t = treg.register_scans_batched([scan_cloud_from_numpy(*c) for c in clouds],
                                        tcfg.RegistrationConfig(**RC5), use_features=True,
                                        cam=cam)
    np.testing.assert_allclose(_np(reg_t.R), reg_j.R, atol=1e-4)
    np.testing.assert_allclose(_np(reg_t.t), reg_j.t, atol=2e-2)
    np.testing.assert_allclose(_np(reg_t.icp_rms), reg_j.icp_rms, rtol=1e-2)
    for rot, tr in _pose_errors(reg_t.R, reg_t.t, poses):
        assert rot < 0.5 and tr < 2.0, (rot, tr)


def test_ba_refine_matches_reference(config4, config5, monkeypatch):
    """The reference's batched poses into the port's BA, with the
    reference's landmark draws."""
    clouds, poses, _, probs, _, _ = config4
    reg_b, reg_j, _ = config5
    _jax_draws(monkeypatch, probs)
    reg_t = treg.ba_refine([scan_cloud_from_numpy(*c) for c in clouds],
                           treg.registered_scans_from_numpy(*reg_b), **BA5)
    np.testing.assert_allclose(_np(reg_t.R), reg_j.R, atol=1e-4)
    np.testing.assert_allclose(_np(reg_t.t), reg_j.t, atol=2e-2)
    np.testing.assert_allclose(float(reg_t.pg_rms), float(reg_j.pg_rms), rtol=1e-3)
    np.testing.assert_array_equal(_np(reg_t.icp_rms), reg_b.icp_rms)
    assert float(reg_t.pg_rms) < 1.5            # tests/test_pipeline.py's BA gate


def test_fuse_scans_matches_reference(config4, config5):
    """The reference's BA poses into the port's fusion: a point whose
    transformed position sits within float32 rounding of a voxel face may
    change voxel, so the clouds are held as sets: voxel counts within
    0.1 %, every fused point within 1e-3 of a reference one but 0.5 %."""
    from scipy.spatial import cKDTree

    clouds = config4[0]
    reg_j = config5[1]
    jp, jv, jc, jn = config5[2]
    tp, tv, tc, tn = treg.fuse_scans([scan_cloud_from_numpy(*c) for c in clouds],
                                     treg.registered_scans_from_numpy(*reg_j),
                                     tcfg.RegistrationConfig(voxel_size=2.0),
                                     capacity=1 << 16)
    assert tuple(tp.shape) == (1 << 16, 3) and tuple(tc.shape) == (1 << 16, 1)
    assert abs(int(tn) - int(jn)) <= 1e-3 * int(jn) and int(tv.sum()) == min(int(tn), 1 << 16)
    d, i = cKDTree(jp[jv]).query(_np(tp[tv]))
    assert np.mean(d < 1e-3) > 0.995
    close = d < 1e-3
    np.testing.assert_allclose(_np(tc[tv])[close], jc[jv][i[close]], atol=1e-4)


def test_register_scans_batched_enters_solver_once_per_round(config4, monkeypatch):
    """The batched rounds enter ICP once per round (chain, closures), not
    once per edge, as the reference's test_pipeline.py holds its own; with
    features, once more per round for the race. With the port's own draws
    the result equals the sequential path's."""
    clouds, poses, _, _, cam, _ = config4
    cl = [scan_cloud_from_numpy(*c) for c in clouds]
    calls = {"n": 0}
    real_icp = treg.icp_point_to_plane

    def counting_icp(*a, **k):
        calls["n"] += 1
        return real_icp(*a, **k)

    monkeypatch.setattr(treg, "icp_point_to_plane", counting_icp)
    rc = tcfg.RegistrationConfig(**RC5)
    reg = treg.register_scans_batched(cl, rc, use_features=False, cam=cam)
    assert calls["n"] == 2, calls["n"]
    calls["n"] = 0
    reg_f = treg.register_scans_batched(cl, rc, use_features=True, cam=cam)
    assert calls["n"] == 4, calls["n"]
    monkeypatch.setattr(treg, "icp_point_to_plane", real_icp)
    seq = treg.register_scans(cl, rc, use_features=True, cam=cam)
    np.testing.assert_allclose(_np(reg_f.R), _np(seq.R), atol=1e-4)
    np.testing.assert_allclose(_np(reg_f.t), _np(seq.t), atol=2e-2)
    for R, t in ((reg.R, reg.t), (reg_f.R, reg_f.t)):
        for rot, tr in _pose_errors(R, t, poses):
            assert rot < 0.5 and tr < 2.0, (rot, tr)


def test_a_mesh_of_one_rank_changes_nothing(config4):
    """``mesh=`` on one rank (no process group): one map block, so the
    batched registration and the distributed BA give the unsharded bits
    (worlds of several ranks: tests/test_torch_dist_product.py)."""
    from slr_torch.dist import make_mesh

    clouds = [scan_cloud_from_numpy(*c) for c in config4[0]]
    rc = tcfg.RegistrationConfig(**RC5)
    reg = treg.register_scans_batched(clouds, rc, use_features=False, mesh=make_mesh())
    ref = treg.register_scans_batched(clouds, rc, use_features=False)
    assert all(torch.equal(a, b) for a, b in zip(reg, ref))
    ba = treg.ba_refine(clouds, ref, n_landmarks=96, iters=2, mesh=make_mesh())
    ba_ref = treg.ba_refine(clouds, ref, n_landmarks=96, iters=2)
    assert all(torch.equal(a, b) for a, b in zip(ba, ba_ref))


def test_config5_end_to_end(config4, config5, tmp_path):
    """The port's config 5 with its own draws: batched registration, BA,
    voxel fusion and the TSDF mesh, held to the reference's gates (poses
    within 0.5 deg and 2 mm, the fused cloud within 2.5 mm RMS of the truth
    union, BA's rms below 1.5), which the reference's fused cloud of the
    same scans meets too (its draws differ: the two RMS differ by ~0.1 mm
    at this 160 x 128 size); then a mesh of more than 1000 faces."""
    from scipy.spatial import cKDTree
    from slr_torch.pipeline.tsdf import fuse_tsdf, write_tsdf_mesh_obj

    clouds, poses, _, _, cam, truths = config4
    cl = [scan_cloud_from_numpy(*c) for c in clouds]
    reg = treg.register_scans_batched(cl, tcfg.RegistrationConfig(**RC5),
                                      use_features=True, cam=cam)
    reg = treg.ba_refine(cl, reg, **BA5)
    assert float(reg.pg_rms) < 1.5
    for rot, tr in _pose_errors(reg.R, reg.t, poses):
        assert rot < 0.5 and tr < 2.0, (rot, tr)
    pts, val, _, n_vox = treg.fuse_scans(cl, reg, tcfg.RegistrationConfig(voxel_size=2.0),
                                         capacity=1 << 16)
    tree = cKDTree(np.concatenate(truths))

    def rms(p):
        return float(np.sqrt(np.mean(tree.query(p)[0] ** 2)))

    rms_t = rms(_np(pts[val]))
    jp, jv = config5[2][:2]
    assert rms_t < 2.5 and rms(jp[jv]) < 2.5, (rms_t, rms(jp[jv]))
    vol = fuse_tsdf(cl, cam, reg.R, reg.t, size_vox=(48, 48, 48), voxel=4.0)
    nv, nf = write_tsdf_mesh_obj(tmp_path / "m.obj", vol)
    assert nf > 1000 and nv == 3 * nf
