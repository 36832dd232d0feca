"""slr_torch pipeline and synth against the JAX reference (CPU).

The whole slice: ``render_scan`` on ``default_rig`` + ``bumps_depth``,
``reconstruct_dense`` (through the fused kernel's plain version on the
CPU), ``reconstruct_scan``, ``accumulate_by_projector`` and ``entry``.
Scan tolerances are those of tests/test_torch_fused_scan.py, for the same
reasons (rare code-edge flips from ulp-level differences).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from slr.config import DecodeConfig as JDecodeConfig
from slr.config import PatternConfig as JPatternConfig
from slr.pipeline import reconstruct as jrec
from slr.synth import bumps_depth as jbumps
from slr.synth import render as jrender
from slr_torch.config import PatternConfig
from slr_torch.entry import entry
from slr_torch.geom.camera import camera_from_numpy
from slr_torch.pipeline import reconstruct as trec
from slr_torch.synth import render as trender
from slr_torch.synth.scene import bumps_depth

torch.set_num_threads(2)

CAM_W, CAM_H = 320, 256
CFG = dict(proj_width=256, proj_height=192, gray_bits=6, phase_steps=4)
RIG = dict(cam_w=CAM_W, cam_h=CAM_H, proj_w=256, proj_h=192, baseline=150.0,
           toe_in_deg=14.0)


@pytest.fixture(scope="module")
def scene():
    """JAX's noiseless render + seeded numpy noise, and the rig on both sides."""
    camj, projj = jrender.default_rig(**RIG)
    scan = jrender.render_scan(camj, projj, jbumps(CAM_H, CAM_W, base=480.0, amp=25.0),
                               JPatternConfig(**CFG))
    frames = np.array(scan.frames)
    noise = np.random.default_rng(2).standard_normal(frames.shape)
    frames = np.clip(frames + 0.005 * noise.astype(np.float32), 0, 1).astype(np.float32)
    cam = camera_from_numpy(jax.tree.map(np.asarray, camj))
    proj = camera_from_numpy(jax.tree.map(np.asarray, projj))
    return camj, projj, cam, proj, frames


def _cloud_agrees(cj, ct):
    mj, mt = np.asarray(cj.mask), ct.mask.numpy()
    assert mt.dtype == bool and ct.points.shape == (CAM_H, CAM_W, 3)
    assert (mj != mt).mean() <= 1e-3
    both = mj & mt
    assert both.mean() > 0.3
    dx = np.abs(np.asarray(cj.x_p) - ct.x_p.numpy())
    assert (dx[both] > 1e-3).mean() <= 1e-4
    agree = both & (dx <= 1e-3)
    assert np.abs(np.asarray(cj.points) - ct.points.numpy())[agree].max() <= 1e-2
    assert np.abs(np.asarray(cj.quality) - ct.quality.numpy()).max() <= 1e-5
    np.testing.assert_array_equal(ct.colors.numpy(), np.asarray(cj.colors))


def test_reconstruct_dense_matches_reference(scene):
    camj, projj, cam, proj, frames = scene
    cj = jrec.reconstruct_dense(jnp.asarray(frames), camj, projj, JPatternConfig(**CFG))
    ct = trec.reconstruct_dense(torch.from_numpy(frames), cam, proj, PatternConfig(**CFG))
    _cloud_agrees(cj, ct)


def test_dense_reconstructor_module(scene):
    _, _, cam, proj, frames = scene
    model = trec.DenseReconstructor(cam, proj, PatternConfig(**CFG))
    assert {f"cam_{n}" for n in ("fx", "dist", "R", "t")} <= set(model.state_dict())
    model = model.to("cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.proj, proj))
    ft = torch.from_numpy(frames)
    a = model(ft)
    b = trec.reconstruct_dense(ft, cam, proj, PatternConfig(**CFG))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(NotImplementedError, match="slice 3"):
        trec.reconstruct_dense(ft, cam, proj, PatternConfig(**CFG), spatial_iters=4)


def test_reconstruct_scan_matches_reference(scene):
    camj, projj, cam, proj, frames = scene
    cj = jrec.reconstruct_scan(jnp.asarray(frames), camj, projj, JPatternConfig(**CFG))
    ct = trec.reconstruct_scan(torch.from_numpy(frames), cam, proj, PatternConfig(**CFG))
    _cloud_agrees(cj, ct)


def test_accumulate_by_projector_matches_reference(scene):
    camj, projj, _, _, frames = scene
    cj = jrec.reconstruct_dense(jnp.asarray(frames), camj, projj, JPatternConfig(**CFG))
    # the same cloud on both sides, so only the segment sums can differ
    ct = trec.ScanCloud(*(torch.tensor(np.asarray(x)) for x in cj))
    for proj_w in (256, 1024):
        pj, mj, colj = jrec.accumulate_by_projector(cj, proj_w)
        pt, mt, colt = trec.accumulate_by_projector(ct, proj_w)
        assert pt.shape == (CAM_H, proj_w, 3)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        # float sums in another order (atomics on the card): relative 1e-5
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(colt.numpy(), np.asarray(colj), rtol=1e-5, atol=1e-6)


def test_render_matches_reference():
    cfgj, cfg = JPatternConfig(**CFG), PatternConfig(**CFG)
    camj, projj = jrender.default_rig(**RIG)
    sj = jrender.render_scan(camj, projj, jbumps(CAM_H, CAM_W, base=480.0, amp=25.0), cfgj)
    cam, proj = trender.default_rig(**RIG)
    for a, b in zip((*camj, *projj), (*cam, *proj)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    st = trender.render_scan(cam, proj, bumps_depth(CAM_H, CAM_W, base=480.0, amp=25.0), cfg)
    assert st.frames.shape == sj.frames.shape and st.frames.dtype == torch.float32
    assert np.abs(st.frames.numpy() - np.asarray(sj.frames)).max() <= 1e-4
    assert np.abs(st.points_true.numpy() - np.asarray(sj.points_true)).max() <= 1e-3
    assert (st.mask_true.numpy() != np.asarray(sj.mask_true)).mean() <= 1e-4
    np.testing.assert_allclose(st.xp_true.numpy(), np.asarray(sj.xp_true), atol=1e-3)
    q = trender.quantize_frames(st.frames)
    assert q.dtype == torch.uint8
    qj = np.asarray(jrender.quantize_frames(jnp.asarray(st.frames.numpy())))
    np.testing.assert_array_equal(q.numpy(), qj)


def test_render_noise_from_generator():
    cam, proj = trender.default_rig(cam_w=64, cam_h=48, proj_w=256, proj_h=192)
    depth = bumps_depth(48, 64, base=480.0, amp=20.0)
    cfg = PatternConfig(**CFG)

    def noisy(seed):
        gen = torch.Generator().manual_seed(seed)
        return trender.render_scan(cam, proj, depth, cfg, noise_std=0.01,
                                   generator=gen).frames

    assert torch.equal(noisy(0), noisy(0)) and not torch.equal(noisy(0), noisy(1))
    clean = trender.render_scan(cam, proj, depth, cfg).frames
    assert 0.005 < float((noisy(0) - clean).std()) < 0.02
    for kw in (dict(cast_shadows=True), dict(defocus_sigma=1.0), dict(proj_gamma=2.2)):
        with pytest.raises(NotImplementedError, match="slice 10"):
            trender.render_scan(cam, proj, depth, cfg, **kw)


def test_accuracy_vs_ground_truth():
    """The port end to end, render included: sub-mm RMS on a noiseless scan."""
    cfg = PatternConfig(**CFG)
    cam, proj = trender.default_rig(**RIG)
    scan = trender.render_scan(cam, proj, bumps_depth(CAM_H, CAM_W, base=480.0, amp=25.0), cfg)
    cloud = trec.DenseReconstructor(cam, proj, cfg)(scan.frames)
    valid = cloud.mask & scan.mask_true
    assert float(valid.float().mean()) > 0.3
    err = torch.linalg.norm(cloud.points - scan.points_true, dim=-1)[valid]
    assert float(err.square().mean().sqrt()) < 0.5


def test_entry_matches_reference_entry():
    forward, (frames,) = entry("cpu")
    pts, mask = forward(frames)
    assert pts.shape == (128, 256, 3) and mask.dtype == torch.bool
    assert float(mask.float().mean()) > 0.5
    fj, (framesj,) = __graft_entry__.entry()
    ptsj, maskj = fj(framesj)
    mj, mt = np.asarray(maskj), mask.numpy()
    assert (mj != mt).mean() <= 1e-3
    both = mj & mt
    assert np.abs(np.asarray(ptsj) - pts.numpy())[both].max() <= 1e-2
