"""slr_torch.calib against the JAX reference (CPU).

The same inputs go through ``slr.calib`` and ``slr_torch.calib``: board
corners made by the reference's ``synth_board_views`` (its own noisy
corners, handed to both), and board views rendered by ``slr.synth`` at the
640x512 fixture of tests/test_calib.py, handed to both as the same numpy
arrays. Both packages solve in float32 with the same formulas; they differ
in summation order, libm rounding and the LAPACK routines behind eigh/svd.

Tolerances, each stated where it is used:
- homographies and extrinsics: 1e-4 relative; the closed-form intrinsics
  1e-3 relative: they come from the smallest eigenvector of a 6x6 V^T V
  whose entries span 12 orders of magnitude (B11 ~ 1/fx^2 beside B33 ~ 1),
  so float32 rounding in another summation order moves them by ~1e-4
  (measured 1.2e-4 on fx at 0.1 px noise); LM then settles both packages
  on one optimum, held at 1e-4 below;
- the LM solves, after 60-80 float32 steps: intrinsics within 1e-4
  relative, RMS within 1e-4 px, poses within 1e-3 (rad, mm), distortion
  within 2e-3 absolute (k3 is weakly determined by 8 views);
- corners within 0.01 px of JAX's, projector corners within 0.01 px.
The end-to-end image calibration is held to the reference's golden gates
(tests/test_calib.py:205-213), on views the port renders itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slr import calib as jcal
from slr.calib import corners as jcorners
from slr.codec import decode_stack as jdecode
from slr.config import DecodeConfig as JDecodeConfig
from slr.config import PatternConfig as JPatternConfig
from slr.geom.camera import make_camera as jmake_camera
from slr.geom.camera import project as jproject
from slr.geom.se3 import so3_exp as jso3_exp
from slr.synth import board_poses as jboard_poses
from slr.synth import render_board_view as jrender_board_view
from slr.synth.render import default_rig as jdefault_rig
from slr_torch import calib as tcal
from slr_torch.calib import corners as tcorners
from slr_torch.calib import lm as tlm
from slr_torch.codec import decode_stack
from slr_torch.config import DecodeConfig, PatternConfig
from slr_torch.geom.camera import camera_from_numpy
from slr_torch.synth import board_poses, render_board_view
from slr_torch.synth.render import default_rig

torch.set_num_threads(2)

FX, FY, CX, CY = 1150.0, 1120.0, 639.5, 511.5
DIST = [-0.18, 0.04, 0.0008, -0.0006, 0.0]
COLS, ROWS, SQ = 9, 6, 20.0
CAM_W, CAM_H = 640, 512
PCFG = dict(proj_width=512, proj_height=384, gray_bits=6, row_gray_bits=5,
            phase_steps=4, row_phase_steps=4)

INTR_RTOL = 1e-4
CLOSED_FORM_RTOL = 1e-3
RMS_ATOL = 1e-4
POSE_ATOL = 1e-3
DIST_ATOL = 2e-3
CORNER_ATOL = 0.01


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=atol)


def _cam_pair():
    camj = jmake_camera(FX, FY, CX, CY, dist=DIST)
    return camj, camera_from_numpy(jax.tree.map(np.asarray, camj))


def _projector_views(obj, rvs, tvs):
    """The reference's stereo fixture (tests/test_calib.py:80-99): a toed-in
    projector with its own intrinsics sees the same board corners."""
    th = np.deg2rad(10.0)
    R_rel = jnp.asarray([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                         [-np.sin(th), 0, np.cos(th)]], jnp.float32)
    t_rel = -R_rel @ jnp.asarray([180.0, 10.0, 5.0], jnp.float32)
    projector = jmake_camera(900.0, 890.0, 511.5, 383.5, dist=[-0.05, 0.01, 0, 0, 0],
                             R=R_rel, t=t_rel)
    img_p = jnp.stack([jproject(projector, (jso3_exp(rvs[v]) @ obj.T).T + tvs[v])[0]
                       for v in range(rvs.shape[0])])
    return img_p, R_rel, t_rel


@pytest.fixture(scope="module")
def views():
    """8 views of noisy corners (0.1 px), the reference's own, and the
    projector's view of the same boards."""
    camj, _ = _cam_pair()
    obj, img, rvs, tvs = jcal.synth_board_views(camj, COLS, ROWS, SQ, 8, seed=4,
                                                noise_px=0.1)
    img_p, R_rel, t_rel = _projector_views(obj, rvs, tvs)
    return obj, img, img_p, R_rel, t_rel


@pytest.fixture(scope="module")
def solved(views):
    """Both packages' camera, projector and stereo solves on ``views``."""
    obj, img, img_p, _, _ = views
    jc = jcal.calibrate_camera(obj, img)
    jp = jcal.calibrate_projector(obj, img_p)
    js = jcal.stereo_calibrate(obj, img, img_p, jc, jp)
    tc = tcal.calibrate_camera(_t(obj), _t(img))
    tp = tcal.calibrate_projector(_t(obj), _t(img_p))
    ts = tcal.stereo_calibrate(_t(obj), _t(img), _t(img_p), tc, tp)
    return (jc, jp, js), (tc, tp, ts)


# ------------------------------------------------------------ board + DLT

def test_board_object_points_match_reference():
    for cols, rows, sq in ((9, 6, 20.0), (7, 5, 12.5)):
        a = jcal.board_object_points(cols, rows, sq)
        b = tcal.board_object_points(cols, rows, sq)
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(_np(b), np.asarray(a))


def test_synth_board_views_match_reference():
    """Noiseless views equal the reference's to float32 rounding (1e-3 px:
    the projection of a pose made from the same numpy draws); noise comes
    from the generator, seeded, at the asked scale."""
    camj, cam = _cam_pair()
    obj, img, rvs, tvs = jcal.synth_board_views(camj, COLS, ROWS, SQ, 5, seed=3)
    o, i, r, t = tcal.synth_board_views(cam, COLS, ROWS, SQ, 5, seed=3)
    np.testing.assert_array_equal(_np(o), np.asarray(obj))
    np.testing.assert_array_equal(_np(r), np.asarray(rvs))
    _close(t, tvs, atol=1e-3)
    _close(i, img, atol=1e-3)

    def noisy(seed):
        gen = torch.Generator().manual_seed(seed)
        return tcal.synth_board_views(cam, COLS, ROWS, SQ, 5, seed=3, noise_px=0.1,
                                      generator=gen)[1]

    assert torch.equal(noisy(0), noisy(0)) and not torch.equal(noisy(0), noisy(1))
    assert 0.08 < float((noisy(0) - i).std()) < 0.12


def test_homography_dlt_matches_reference(views):
    """Batched over views, against the reference vmapped (1e-4 relative);
    and exact on a distortion-free view (the reference's own check)."""
    obj, img, _, _, _ = views
    Hj = jax.vmap(lambda uv: jcal.homography_dlt(obj[:, :2], uv))(img)
    Ht = tcal.homography_dlt(_t(obj)[:, :2], _t(img))
    assert Ht.shape == (8, 3, 3)
    _close(Ht, Hj, rtol=INTR_RTOL, atol=INTR_RTOL * float(np.abs(Hj).max()))
    cam = jmake_camera(FX, FY, CX, CY)
    obj1, img1, _, _ = jcal.synth_board_views(cam, COLS, ROWS, SQ, 1, seed=2)
    H = tcal.homography_dlt(_t(obj1)[:, :2], _t(img1[0]))
    xy1 = torch.cat([_t(obj1)[:, :2], torch.ones(COLS * ROWS, 1)], dim=1)
    uvw = xy1 @ H.T
    assert float((uvw[:, :2] / uvw[:, 2:3] - _t(img1[0])).abs().max()) < 1e-2


def test_zhang_init_intrinsics_matches_reference(views):
    obj, img, _, _, _ = views
    Hj = jax.vmap(lambda uv: jcal.homography_dlt(obj[:, :2], uv))(img)
    a = jcal.zhang_init_intrinsics(Hj)
    b = tcal.zhang_init_intrinsics(_t(Hj))
    for x, y in zip(b, a):
        _close(x, y, rtol=CLOSED_FORM_RTOL)


def test_extrinsics_from_homography_matches_reference(views):
    """All views in one call against the reference vmapped (1e-4)."""
    obj, img, _, _, _ = views
    Hj = jax.vmap(lambda uv: jcal.homography_dlt(obj[:, :2], uv))(img)
    fx, fy, cx, cy = jcal.zhang_init_intrinsics(Hj)
    rj, tj = jax.vmap(lambda H: jcal.extrinsics_from_homography(H, fx, fy, cx, cy))(Hj)
    rt, tt = tcal.extrinsics_from_homography(_t(Hj), *(_t(v) for v in (fx, fy, cx, cy)))
    _close(rt, rj, atol=INTR_RTOL)
    _close(tt, tj, rtol=INTR_RTOL, atol=INTR_RTOL)


def _toy_residual(x, t, y):
    """y = a exp(b t) + c: 3 parameters, 40 residuals."""
    return x[0] * torch.exp(x[1] * t) + x[2] - y


def _toy_residual_j(x, t, y):
    return x[0] * jnp.exp(x[1] * t) + x[2] - y


def test_lm_solve_toy_matches_reference():
    """The masked loop against the reference's early-exit while_loop on a
    toy fit (x within 1e-4; the cost within 1e-4 relative: each residual
    ~0.01 is the float32 difference of terms ~2, so it carries ~1e-5
    relative rounding of its own); once ``done`` is set the state freezes:
    more steps give the same bits and the same count of active steps."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2, 40).astype(np.float32)
    y = (2.0 * np.exp(-1.3 * t) + 0.5 + 0.01 * rng.normal(size=40)).astype(np.float32)
    x0 = np.array([1.0, -0.5, 0.0], np.float32)
    xj, cj = jcal.lm_solve(_toy_residual_j, jnp.asarray(x0), args=(jnp.asarray(t),
                                                                   jnp.asarray(y)),
                           iters=50, tol=1e-6)
    xt, ct = tcal.lm_solve(_toy_residual, _t(x0), args=(_t(t), _t(y)), iters=50, tol=1e-6)
    steps = int(tlm.lm_solve.steps)
    assert 0 < steps < 50
    _close(xt, xj, rtol=1e-4, atol=1e-4)
    _close(ct, cj, rtol=1e-4)
    xt2, ct2 = tcal.lm_solve(_toy_residual, _t(x0), args=(_t(t), _t(y)), iters=80, tol=1e-6)
    assert torch.equal(xt2, xt) and torch.equal(ct2, ct)
    assert int(tlm.lm_solve.steps) == steps


# ------------------------------------------------------------ solves

def _result_close(t_res, j_res, intr_rtol=INTR_RTOL):
    """Field by field through the carry-across: intrinsics relative, the
    distortion, poses and RMS absolute."""
    a, b = jax.tree.map(np.asarray, j_res), tcal.calib_result_to_numpy(t_res)
    cams = (("camera",) if "camera" in a._fields else ("cam", "proj"))
    for name in cams:
        ca, cb = getattr(a, name), getattr(b, name)
        for f in ("fx", "fy", "cx", "cy"):
            _close(getattr(cb, f), getattr(ca, f), rtol=intr_rtol)
        _close(cb.dist, ca.dist, atol=DIST_ATOL)
        _close(cb.R, ca.R, atol=POSE_ATOL)
        _close(cb.t, ca.t, atol=POSE_ATOL * 100)
    _close(b.rvecs, a.rvecs, atol=POSE_ATOL)
    _close(b.tvecs, a.tvecs, atol=POSE_ATOL * 100)
    _close(b.rms, a.rms, atol=RMS_ATOL)


def test_calibrate_camera_matches_reference(solved):
    (jc, _, _), (tc, _, _) = solved
    assert tc.rvecs.shape == (8, 3) and tc.rms.dtype == torch.float32
    _result_close(tc, jc)


def test_calibrate_projector_matches_reference(solved):
    (_, jp, _), (_, tp, _) = solved
    _result_close(tp, jp)


def test_stereo_calibrate_matches_reference(solved, views):
    """The joint solve against the reference's, and the relative pose
    recovered as the reference's test demands of it."""
    (_, _, js), (_, _, ts) = solved
    _result_close(ts, js)
    _, _, _, R_rel, t_rel = views
    _close(ts.proj.R, R_rel, atol=2e-3)
    _close(ts.proj.t, t_rel, rtol=0.02, atol=0.5)
    assert abs(float(ts.proj.fx) - 900.0) / 900.0 < 5e-3


def test_calibrate_camera_noiseless_recovers_truth():
    """tests/test_calib.py's truth gates on the port alone."""
    _, cam = _cam_pair()
    obj, img, _, _ = tcal.synth_board_views(cam, COLS, ROWS, SQ, 8, seed=3)
    res = tcal.calibrate_camera(obj, img)
    assert float(res.rms) < 0.05
    np.testing.assert_allclose(float(res.camera.fx), FX, rtol=2e-3)
    np.testing.assert_allclose(float(res.camera.fy), FY, rtol=2e-3)
    np.testing.assert_allclose(float(res.camera.cx), CX, atol=2.0)
    np.testing.assert_allclose(float(res.camera.cy), CY, atol=2.0)
    np.testing.assert_allclose(_np(res.camera.dist[:2]), DIST[:2], atol=5e-3)


def test_calibrate_camera_parity_with_cv2(views):
    """tests/test_calib.py's cv2 parity case on the port (cv2 is an oracle
    of this box only)."""
    cv2 = pytest.importorskip("cv2")
    camj, cam = _cam_pair()
    obj, img, _, _ = jcal.synth_board_views(camj, COLS, ROWS, SQ, 10, seed=4, noise_px=0.1)
    rms_cv, K_cv, dist_cv, _, _ = cv2.calibrateCamera(
        [np.asarray(obj, np.float32)] * 10,
        [np.asarray(v, np.float32).reshape(-1, 1, 2) for v in img], (1280, 1024), None, None)
    res = tcal.calibrate_camera(_t(obj), _t(img))
    np.testing.assert_allclose(float(res.camera.fx), K_cv[0, 0], rtol=2e-3)
    np.testing.assert_allclose(float(res.camera.fy), K_cv[1, 1], rtol=2e-3)
    np.testing.assert_allclose(float(res.camera.cx), K_cv[0, 2], atol=1.5)
    np.testing.assert_allclose(float(res.camera.cy), K_cv[1, 2], atol=1.5)
    np.testing.assert_allclose(_np(res.camera.dist[:2]), dist_cv.ravel()[:2], atol=2e-2)
    assert float(res.rms) < max(1.25 * rms_cv, 0.15)


def test_calib_result_numpy_round_trip(solved):
    """The carry-across: the port's results to numpy fields and back are
    the same bits, and the JAX results come across as port results."""
    (jc, _, js), (tc, _, ts) = solved
    for res in (tc, ts):
        back = tcal.calib_result_from_numpy(tcal.calib_result_to_numpy(res))
        assert type(back) is type(res)
        for a, b in zip(jax.tree.leaves(tuple(res)), jax.tree.leaves(tuple(back))):
            assert torch.equal(a, b)
    for jres, kind in ((jc, tcal.CalibrationResult), (js, tcal.StereoResult)):
        res = tcal.calib_result_from_numpy(jax.tree.map(np.asarray, jres))
        assert type(res) is kind
        _result_close(res, jres, intr_rtol=0.0)


# ------------------------------------------------------------ image front end

@pytest.fixture(scope="module")
def board():
    """Three board views rendered by slr.synth at the 640x512 fixture of
    tests/test_calib.py, noise 0.005; the rig on both sides."""
    camj, projj = jdefault_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=512, proj_h=384)
    cfg = JPatternConfig(**PCFG)
    out = []
    for i, (R, t) in enumerate(jboard_poses(3, COLS, ROWS, SQ, seed=4)):
        bv = jrender_board_view(camj, projj, cfg, R, t, COLS, ROWS, SQ, CAM_H, CAM_W,
                                noise_std=0.005, key=jax.random.PRNGKey(50 + i))
        out.append(jax.tree.map(np.asarray, bv))
    return out


def test_corner_candidates_match_reference(board):
    """The same candidates in the same order, filler rows included: equal
    scores come lowest index first, as jax.lax.top_k gives them. Scores
    within 1e-5 of the largest: Ixy^2 - Ixx Iyy cancels second differences
    of a float32 smoothing summed in another order."""
    for bv in board[:2]:
        cj, sj = jcorners.corner_candidates(jnp.asarray(bv.white_image), 66)
        ct, st = tcorners.corner_candidates(_t(bv.white_image), 66)
        np.testing.assert_array_equal(_np(ct), np.asarray(cj))
        _close(st, sj, atol=1e-5 * float(np.max(sj)))
    # a small checker with few saddles and k = 12: the filler rows (score
    # 0, all tied) are the same pixels in the same order, lowest index first
    img = np.zeros((64, 80), np.float32)
    img[16:32, 20:40] = img[32:48, 40:60] = 1.0
    img[16:32, 40:60] = img[32:48, 20:40] = 0.2
    cj, sj = jcorners.corner_candidates(jnp.asarray(img), 12)
    ct, st = tcorners.corner_candidates(_t(img), 12)
    zero = np.asarray(sj) == 0
    assert zero.sum() >= 4
    np.testing.assert_array_equal(_np(st) == 0, zero)
    np.testing.assert_array_equal(_np(ct)[zero], np.asarray(cj)[zero])
    np.testing.assert_array_equal(_np(ct)[zero][:, 0], np.arange(zero.sum()))


def test_refine_subpix_matches_reference(board):
    """From the true corners moved by up to 1.5 px: within 0.01 px."""
    rng = np.random.default_rng(1)
    for bv in board:
        start = (bv.corners_cam_true + rng.uniform(-1.5, 1.5, bv.corners_cam_true.shape)
                 ).astype(np.float32)
        a = jcorners.refine_subpix(jnp.asarray(bv.white_image), jnp.asarray(start))
        b = tcorners.refine_subpix(_t(bv.white_image), _t(start))
        _close(b, a, atol=CORNER_ATOL)


def _valid_candidates(bv):
    K = COLS * ROWS
    cand, score = jcorners.corner_candidates(jnp.asarray(bv.white_image), K + 12)
    valid = (score > 0) & (score >= 0.5 * jnp.sort(score)[::-1][K - 1])
    return np.asarray(cand), np.asarray(valid)


def test_order_corner_grid_device_matches_reference(board):
    """The same nodes in the same order, ok on every view, rms within 1e-4."""
    for bv in board:
        cand, valid = _valid_candidates(bv)
        oj, rj, kj = jcorners.order_corner_grid_device(jnp.asarray(cand), jnp.asarray(valid),
                                                       COLS, ROWS)
        ot, rt, kt = tcorners.order_corner_grid_device(_t(cand), _t(valid), COLS, ROWS)
        assert bool(kj) and bool(kt)
        np.testing.assert_array_equal(_np(ot), np.asarray(oj))
        _close(rt, rj, atol=1e-4)


def test_order_corner_grid_matches_reference(board):
    """The host path (numpy, scipy's hull): the same ordering and rms."""
    for bv in board:
        cand, valid = _valid_candidates(bv)
        oj, rj = jcorners.order_corner_grid(cand[valid], COLS, ROWS)
        ot, rt = tcorners.order_corner_grid(cand[valid], COLS, ROWS)
        np.testing.assert_array_equal(ot, oj)
        assert rt == rj


def test_detect_chessboard_matches_reference(board):
    """Device path on every view (counted), corners within 0.01 px of JAX's
    and within the reference's gates of the truth (tests/test_calib.py:
    143-144)."""
    n = tcorners.detect_chessboard.device_views
    for bv in board:
        cj, rj = jcorners.detect_chessboard(bv.white_image, COLS, ROWS)
        ct, rt = tcorners.detect_chessboard(_t(bv.white_image), COLS, ROWS)
        assert ct.shape == (COLS * ROWS, 2) and ct.dtype == torch.float32
        _close(ct, cj, atol=CORNER_ATOL)
        assert abs(rt - rj) < 1e-4
        err = np.linalg.norm(_np(ct) - bv.corners_cam_true, axis=1)
        assert err.max() < 0.8 and err.mean() < 0.4
    assert tcorners.detect_chessboard.device_views - n == len(board)


def test_detect_chessboard_host_path_matches_reference(board, monkeypatch):
    """Where the device ordering reports ok=False, both packages take the
    host path: the same corners (0.01 px), counted as a host view."""
    def refuse(mod):
        orig = mod.order_corner_grid_device

        def not_ok(*a, **k):
            o, r, _ = orig(*a, **k)
            return o, r, r < 0
        return not_ok

    monkeypatch.setattr(jcorners, "order_corner_grid_device", refuse(jcorners))
    monkeypatch.setattr(tcorners, "order_corner_grid_device", refuse(tcorners))
    bv = board[0]
    n = tcorners.detect_chessboard.host_views
    cj, rj = jcorners.detect_chessboard(bv.white_image, COLS, ROWS)
    ct, rt = tcorners.detect_chessboard(_t(bv.white_image), COLS, ROWS)
    assert tcorners.detect_chessboard.host_views == n + 1
    _close(ct, cj, atol=CORNER_ATOL)
    assert rt == pytest.approx(rj, abs=1e-9)


def test_chessboard_detection_vs_cv2(board):
    """tests/test_calib.py's cv2 oracle on the port's corners: within 0.3 px
    mean of cv2's findChessboardCorners + cornerSubPix."""
    cv2 = pytest.importorskip("cv2")
    for bv in board:
        corners = _np(tcorners.detect_chessboard(_t(bv.white_image), COLS, ROWS)[0])
        img8 = (bv.white_image * 255).astype(np.uint8)
        ok, cv_c = cv2.findChessboardCorners(img8, (COLS, ROWS))
        assert ok
        cv_c = cv2.cornerSubPix(
            img8, cv_c.astype(np.float32), (5, 5), (-1, -1),
            (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3)).reshape(-1, 2)
        d = min(np.linalg.norm(corners - cv_c, axis=1).mean(),
                np.linalg.norm(corners - cv_c[::-1], axis=1).mean())
        assert d < 0.3


def test_projector_corners_from_decode_matches_reference(board):
    """JAX's decode and corners handed to both: within 0.01 projector px,
    the same support flags; the port's own decode gives the truth within
    the reference's gates (mean < 0.3, max < 1.0 projector px)."""
    cfg = JPatternConfig(**PCFG)
    for bv in board[:2]:
        res = jdecode(jnp.asarray(bv.scan.frames), cfg, JDecodeConfig())
        corners = np.asarray(jcorners.detect_chessboard(bv.white_image, COLS, ROWS)[0])
        pj, okj = jcal.projector_corners_from_decode(res.x_p, res.y_p, res.mask, res.quality,
                                                     jnp.asarray(corners))
        pt, okt = tcal.projector_corners_from_decode(
            *(_t(x) for x in (res.x_p, res.y_p, res.mask, res.quality)), _t(corners))
        np.testing.assert_array_equal(_np(okt), np.asarray(okj))
        _close(pt, pj, atol=CORNER_ATOL)
        own = decode_stack(_t(bv.scan.frames), PatternConfig(**PCFG), DecodeConfig())
        pown, ok = tcal.projector_corners_from_decode(own.x_p, own.y_p, own.mask, own.quality,
                                                      _t(corners))
        err = np.linalg.norm(_np(pown) - bv.corners_proj_true, axis=1)
        assert bool(ok.all()) and err.mean() < 0.3 and err.max() < 1.0


def test_calibrate_from_images_golden():
    """The port end to end on 8 views it renders itself (noise 0.003 from
    seeded generators): detected corners -> decoded projector corners ->
    Zhang + joint LM recovers the true rig within the reference's golden
    gates (tests/test_calib.py:205-213)."""
    cam, proj = default_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=512, proj_h=384)
    cfg = PatternConfig(**PCFG)
    whites, stacks, truth = [], [], []
    for i, (R, t) in enumerate(board_poses(8, COLS, ROWS, SQ, seed=0)):
        bv = render_board_view(cam, proj, cfg, R, t, COLS, ROWS, SQ, CAM_H, CAM_W,
                               noise_std=0.003, generator=torch.Generator().manual_seed(i))
        whites.append(bv.white_image)
        stacks.append(bv.scan.frames)
        truth.append(bv.corners_cam_true)
    res = tcal.calibrate_from_images(whites, stacks, COLS, ROWS, SQ, cfg)
    st = res.stereo
    assert res.corners_cam.shape == res.corners_proj.shape == (8, COLS * ROWS, 2)
    err = torch.linalg.norm(res.corners_cam - torch.stack(truth), dim=-1)
    assert float(err.max()) < 0.8 and float(err.mean()) < 0.4
    assert float(st.rms) < 0.5
    for got, true in ((st.cam.fx, cam.fx), (st.cam.fy, cam.fy),
                      (st.proj.fx, proj.fx), (st.proj.fy, proj.fy)):
        assert abs(float(got) - float(true)) / float(true) < 0.01
    assert abs(float(st.cam.cx) - float(cam.cx)) < 5.0
    assert abs(float(st.cam.cy) - float(cam.cy)) < 5.0
    assert float((st.proj.R - proj.R).abs().max()) < 4e-3
    assert float((st.proj.t - proj.t).abs().max()) < 2.0


def test_calibrate_from_images_rejects_like_reference(board):
    """Column-only coding cannot calibrate the projector; a board whose
    corners lack decoded support is refused. Both with the reference's
    messages."""
    col_only = dict(proj_width=512, proj_height=384, gray_bits=6, phase_steps=4)
    white, frames = [board[0].white_image], [board[0].scan.frames]
    with pytest.raises(ValueError) as ej:
        jcal.calibrate_from_images(white, frames, COLS, ROWS, SQ, JPatternConfig(**col_only))
    with pytest.raises(ValueError) as et:
        tcal.calibrate_from_images([_t(white[0])], [_t(frames[0])], COLS, ROWS, SQ,
                                   PatternConfig(**col_only))
    assert str(et.value) == str(ej.value)
    dark = frames[0].copy()
    dark[:, :, : CAM_W // 2] = 0.0          # no pattern on the left half
    with pytest.raises(ValueError, match="lack valid decoded support"):
        tcal.calibrate_from_images([_t(white[0])], [_t(dark)], COLS, ROWS, SQ,
                                   PatternConfig(**PCFG))
