"""slr_torch.synth's calibration board and projector optics against the
JAX reference (CPU).

``board_poses`` (the same numpy draws), the board's ray-cast depth and
checker albedo, ``render_board_view`` with its true corners, and
``render_scan`` with defocus and projector gamma live in
tests/test_torch_pipeline.py beside the other render cases. Tolerances are
tests/test_torch_pipeline.py's for renders: frames within 1e-4 (float32
rays and a cosine of a phase ~100 rad), depth within 1e-3 mm, corners
within 1e-3 px; board albedo equal except on rare pixels whose ray lands
on a square's edge within float32 rounding (<= 1e-4 of the pixels).
"""

import jax
import numpy as np
import pytest
import torch

from slr.config import PatternConfig as JPatternConfig
from slr.synth import board as jboard
from slr.synth.render import default_rig as jdefault_rig
from slr_torch.config import PatternConfig
from slr_torch.geom.camera import camera_from_numpy
from slr_torch.synth import board as tboard

torch.set_num_threads(2)

COLS, ROWS, SQ = 9, 6, 20.0
CAM_W, CAM_H = 320, 256
PCFG = dict(proj_width=256, proj_height=192, gray_bits=5, row_gray_bits=4,
            phase_steps=4, row_phase_steps=4)


@pytest.fixture(scope="module")
def rig():
    camj, projj = jdefault_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=256, proj_h=192)
    return (camj, projj, camera_from_numpy(jax.tree.map(np.asarray, camj)),
            camera_from_numpy(jax.tree.map(np.asarray, projj)))


def test_board_poses_match_reference():
    """The same numpy draws: rotations within 1e-6 (float32 sin/cos),
    translations within 1e-4 mm."""
    pj = jboard.board_poses(5, COLS, ROWS, SQ, seed=3)
    pt = tboard.board_poses(5, COLS, ROWS, SQ, seed=3)
    assert len(pt) == 5
    for (Rj, tj), (Rt, tt) in zip(pj, pt):
        assert Rt.dtype == tt.dtype == torch.float32
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-6)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)


@pytest.mark.parametrize("view", [0, 1])
def test_board_plane_depth_albedo_matches_reference(rig, view):
    camj, _, cam, _ = rig
    R, t = jboard.board_poses(2, COLS, ROWS, SQ, seed=0)[view]
    dj, aj = jboard._board_plane_depth_albedo(camj, CAM_H, CAM_W, R, t, COLS, ROWS, SQ)
    dt, at = tboard._board_plane_depth_albedo(cam, CAM_H, CAM_W, torch.tensor(np.asarray(R)),
                                              torch.tensor(np.asarray(t)), COLS, ROWS, SQ)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-3)
    assert (at.numpy() != np.asarray(aj)).mean() <= 1e-4
    assert set(np.unique(at.numpy())) == {np.float32(v) for v in (0.12, 0.95, 0.15)}


@pytest.mark.parametrize("view", [0, 1, 2])
def test_render_board_view_matches_reference(rig, view):
    camj, projj, cam, proj = rig
    R, t = jboard.board_poses(3, COLS, ROWS, SQ, seed=1)[view]
    bj = jboard.render_board_view(camj, projj, JPatternConfig(**PCFG), R, t, COLS, ROWS, SQ,
                                  CAM_H, CAM_W)
    bt = tboard.render_board_view(cam, proj, PatternConfig(**PCFG),
                                  torch.tensor(np.asarray(R)), torch.tensor(np.asarray(t)),
                                  COLS, ROWS, SQ, CAM_H, CAM_W)
    assert bt.scan.frames.shape == bj.scan.frames.shape
    assert torch.equal(bt.white_image, bt.scan.frames[0])
    assert np.abs(bt.scan.frames.numpy() - np.asarray(bj.scan.frames)).max() <= 1e-4
    np.testing.assert_allclose(bt.depth.numpy(), np.asarray(bj.depth), atol=1e-3)
    np.testing.assert_allclose(bt.corners_cam_true.numpy(), np.asarray(bj.corners_cam_true),
                               atol=1e-3)
    np.testing.assert_allclose(bt.corners_proj_true.numpy(),
                               np.asarray(bj.corners_proj_true), atol=1e-3)


def test_render_board_view_noise_from_generator(rig):
    """Noise from the generator: seeded, of the asked scale."""
    _, _, cam, proj = rig
    R, t = tboard.board_poses(1, COLS, ROWS, SQ, seed=0)[0]
    cfg = PatternConfig(**PCFG)

    def white(seed, noise=0.01):
        gen = torch.Generator().manual_seed(seed)
        return tboard.render_board_view(cam, proj, cfg, R, t, COLS, ROWS, SQ, CAM_H, CAM_W,
                                        noise_std=noise, generator=gen).white_image

    assert torch.equal(white(0), white(0)) and not torch.equal(white(0), white(1))
    clean = white(0, noise=0.0)
    inside = (clean > 0.02) & (clean < 0.98)     # away from the clip at 0 and 1
    assert 0.008 < float((white(0) - clean)[inside].std()) < 0.012
