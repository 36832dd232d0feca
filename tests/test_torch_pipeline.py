"""slr_torch pipeline and synth against the JAX reference (CPU).

The whole slice: ``render_scan`` on ``default_rig`` + ``bumps_depth`` (and
``checker_albedo``, multifreq patterns), ``reconstruct_dense`` (through the
kernels' plain versions on the CPU, float32 and integer stacks, with and
without the spatial repair), ``reconstruct_scan``,
``accumulate_by_projector`` and ``entry``; the exposure-bracket path is
tests/test_torch_hdr.py.
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
from slr_torch.config import DecodeConfig, PatternConfig
from slr_torch.entry import entry
from slr_torch.geom.camera import camera_from_numpy
from slr_torch.pipeline import reconstruct as trec
from slr_torch.synth import render as trender
from slr_torch.synth.scene import bumps_depth, checker_albedo

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
    # the spatial repair: spatial_iters from the module, the mode from dec
    for mode in ("voting", "wavefront"):
        dec = DecodeConfig(spatial_unwrap_mode=mode)
        a = trec.DenseReconstructor(cam, proj, PatternConfig(**CFG), dec,
                                    spatial_iters=4)(ft)
        b = trec.reconstruct_dense(ft, cam, proj, PatternConfig(**CFG), dec,
                                   spatial_iters=4, spatial_mode=mode)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


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
    # cast shadows are ported: they only ever take light away
    lit = trender.render_scan(cam, proj, depth, cfg, cast_shadows=True).mask_true
    unshadowed = trender.render_scan(cam, proj, depth, cfg).mask_true
    assert bool((lit <= unshadowed).all()) and bool(lit.any())


@pytest.mark.parametrize("optics", [dict(defocus_sigma=1.0), dict(proj_gamma=2.2),
                                    dict(defocus_sigma=1.0, proj_gamma=2.2)],
                         ids=["defocus", "gamma", "defocus_gamma"])
@pytest.mark.parametrize("coding", ["gray_phase", "multifreq"])
def test_render_optics_match_reference(optics, coding):
    """Defocus and projector gamma against slr.synth's frames (1e-4, the
    render tolerance above), on the discrete frames (white, black and the
    Gray patterns, gamma'd and blurred, then sampled) and on the analytic
    fringes (the gamma'd profile's Fourier series, each harmonic attenuated
    by the PSF), rows coded too; and the optics change the frames."""
    kw = (dict(CFG, row_gray_bits=5, row_phase_steps=4) if coding == "gray_phase"
          else dict(proj_width=256, proj_height=192, coding="multifreq", phase_steps=4))
    camj, projj = jrender.default_rig(**dict(RIG, cam_w=160, cam_h=128))
    depth = jbumps(128, 160, base=480.0, amp=25.0)
    sj = jrender.render_scan(camj, projj, depth, JPatternConfig(**kw), **optics)
    cam, proj = trender.default_rig(**dict(RIG, cam_w=160, cam_h=128))
    cfg = PatternConfig(**kw)
    st = trender.render_scan(cam, proj, torch.tensor(np.asarray(depth)), cfg, **optics)
    n_fringe = (cfg.mf_levels * cfg.phase_steps if coding == "multifreq"
                else cfg.phase_steps + cfg.row_phase_steps)
    a, b = np.asarray(sj.frames), st.frames.numpy()
    assert b.shape == a.shape
    assert np.abs(b[:-n_fringe] - a[:-n_fringe]).max() <= 1e-4      # discrete
    assert np.abs(b[-n_fringe:] - a[-n_fringe:]).max() <= 1e-4      # analytic
    ideal = trender.render_scan(cam, proj, torch.tensor(np.asarray(depth)), cfg).frames
    assert float((st.frames[-n_fringe:] - ideal[-n_fringe:]).abs().max()) > 1e-2


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


def test_entry_defaults_to_the_card(monkeypatch):
    """``entry()`` with no argument runs on the card: without one it raises
    and does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry("cuda")


def test_checker_albedo_matches_reference():
    from slr.synth import checker_albedo as jchecker

    for h, w, kw in ((256, 320, {}), (215, 300, dict(cells=6, lo=0.035, hi=0.75)),
                     (1024, 1280, dict(cells=8, lo=0.035, hi=0.75))):
        a = checker_albedo(h, w, **kw)
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(jchecker(h, w, **kw)))


@pytest.mark.parametrize("kw", [
    dict(CFG, row_gray_bits=5, row_phase_steps=4),
    dict(proj_width=256, proj_height=192, coding="multifreq", phase_steps=4,
         mf_levels=3, mf_ratio=6.0),
])
def test_render_albedo_and_codings_match_reference(kw):
    from slr.synth import checker_albedo as jchecker

    camj, projj = jrender.default_rig(**RIG)
    sj = jrender.render_scan(camj, projj, jbumps(CAM_H, CAM_W, base=480.0, amp=25.0),
                             JPatternConfig(**kw),
                             albedo=jchecker(CAM_H, CAM_W, cells=6, lo=0.035, hi=0.75))
    cam, proj = trender.default_rig(**RIG)
    st = trender.render_scan(cam, proj, bumps_depth(CAM_H, CAM_W, base=480.0, amp=25.0),
                             PatternConfig(**kw),
                             albedo=checker_albedo(CAM_H, CAM_W, cells=6, lo=0.035, hi=0.75))
    assert st.frames.shape == sj.frames.shape == (PatternConfig(**kw).num_frames,
                                                  CAM_H, CAM_W)
    assert np.abs(st.frames.numpy() - np.asarray(sj.frames)).max() <= 1e-4


@pytest.mark.parametrize("dtype", ["uint8", "uint16"])
def test_reconstruct_dense_integer_stack_matches_reference(scene, dtype):
    """reconstruct_dense hands an integer stack to the kernel unchanged (the
    container's full range: uint16 here holds 16-bit data)."""
    camj, projj, cam, proj, frames = scene
    q = np.asarray(trender.quantize_frames(torch.from_numpy(frames),
                                           getattr(torch, dtype)))
    cj = jrec.reconstruct_dense(jnp.asarray(q), camj, projj, JPatternConfig(**CFG))
    ct = trec.reconstruct_dense(torch.from_numpy(q), cam, proj, PatternConfig(**CFG))
    mj, mt = np.asarray(cj.mask), ct.mask.numpy()
    assert (mj != mt).mean() <= 1e-3
    both = mj & mt
    assert both.mean() > 0.3
    dx = np.abs(np.asarray(cj.x_p) - ct.x_p.numpy())
    assert (dx[both] > 1e-3).mean() <= 1e-4
    assert np.abs(np.asarray(cj.points) - ct.points.numpy())[both & (dx <= 1e-3)].max() <= 1e-2
    assert np.abs(np.asarray(cj.quality) - ct.quality.numpy()).max() <= 1e-5
    # XLA turns the jitted division by the ADC maximum into a product with
    # its reciprocal: 1 ulp
    np.testing.assert_allclose(ct.colors.numpy(), np.asarray(cj.colors), rtol=0,
                               atol=6e-8)


# --- the spatial repair (reconstruct_dense(spatial_iters > 0)) ---------------

# the default rig geometry at 320x256, noise 0.01: order errors to repair
FAULT_RIG = dict(cam_w=CAM_W, cam_h=CAM_H, proj_w=256, proj_h=192)


def _noisy_scene(cfg_kw, key):
    """JAX's render with its own noise (the same frames go to both
    packages), on the default rig geometry."""
    camj, projj = jrender.default_rig(**FAULT_RIG)
    scan = jrender.render_scan(camj, projj, jbumps(CAM_H, CAM_W, base=480.0, amp=25.0),
                               JPatternConfig(**cfg_kw), noise_std=0.01,
                               key=jax.random.PRNGKey(key))
    cam = camera_from_numpy(jax.tree.map(np.asarray, camj))
    proj = camera_from_numpy(jax.tree.map(np.asarray, projj))
    return camj, projj, cam, proj, np.array(scan.frames), np.asarray(scan.mask_true)


@pytest.fixture(scope="module")
def noisy_scene():
    return _noisy_scene(CFG, 9)


def _spatial_agrees(scene, cfg_kw, mode, pitch):
    """Port and JAX with spatial_iters=4: on JAX's unrepaired mask, points
    and x_p agree; the repaired pixels (|dx_p| > pitch/2) are one set; the
    port's mask is its own unrepaired mask. Returns (JAX's base and
    repaired clouds, the port's base and repaired clouds)."""
    camj, projj, cam, proj, frames, _ = scene
    fj, ft = jnp.asarray(frames), torch.from_numpy(frames)
    cfgj, cfg = JPatternConfig(**cfg_kw), PatternConfig(**cfg_kw)
    bj = jrec.reconstruct_dense(fj, camj, projj, cfgj)
    cj = jrec.reconstruct_dense(fj, camj, projj, cfgj, spatial_iters=4, spatial_mode=mode)
    bt = trec.reconstruct_dense(ft, cam, proj, cfg)
    ct = trec.reconstruct_dense(ft, cam, proj, cfg, spatial_iters=4, spatial_mode=mode)
    m0 = np.asarray(bj.mask)
    dx = np.abs(np.asarray(cj.x_p) - ct.x_p.numpy())[m0]
    assert (dx > 1e-3).mean() <= 1e-4
    agree = m0 & (np.abs(np.asarray(cj.x_p) - ct.x_p.numpy()) <= 1e-3)
    assert np.abs(np.asarray(cj.points) - ct.points.numpy())[agree].max() <= 1e-2
    fixed_j = np.abs(np.asarray(cj.x_p) - np.asarray(bj.x_p)) > pitch / 2
    fixed_t = (ct.x_p - bt.x_p).abs().numpy() > pitch / 2
    np.testing.assert_array_equal(fixed_t, fixed_j)
    assert fixed_t.sum() > 0
    assert torch.equal(ct.mask, bt.mask)
    # unrepaired pixels keep the decode's x_p and points bit for bit
    assert torch.equal(ct.x_p[~torch.from_numpy(fixed_t)], bt.x_p[~torch.from_numpy(fixed_t)])
    keep = ~torch.from_numpy(fixed_t)
    assert torch.equal(ct.points[keep], bt.points[keep])
    return bj, cj, bt, ct


@pytest.mark.parametrize("mode", ["voting", "wavefront"])
def test_reconstruct_dense_spatial_matches_reference(noisy_scene, mode):
    _spatial_agrees(noisy_scene, CFG, mode, PatternConfig(**CFG).fringe_pitch)


def test_reconstruct_dense_spatial_multifreq_matches_reference():
    """Multifreq: the repair works at the finest pitch, mf_pitches[-1].
    The decode makes no order errors on this scene, so 40 pixels get the
    middle level's four phase frames rolled by one (a quarter-period phase
    error there, one or two finest periods after the hierarchy)."""
    kw = dict(proj_width=256, proj_height=192, coding="multifreq", phase_steps=4,
              mf_levels=3, mf_ratio=6.0)
    scene = _noisy_scene(kw, 4)
    frames = scene[4]
    rng = np.random.default_rng(5)
    r, c = rng.integers(40, CAM_H - 40, 40), rng.integers(40, CAM_W - 40, 40)
    frames[6:10, r, c] = np.roll(frames[6:10, r, c], 1, axis=0)
    pitch = PatternConfig(**kw).mf_pitches[-1]
    assert pitch != PatternConfig(**kw).fringe_pitch
    _spatial_agrees(scene, kw, "voting", pitch)


def test_reference_spatial_mask_growth_is_not_ported(noisy_scene):
    """The reference marks a pixel changed when |x_p2 - x_p| > 1e-6, which
    the float32 x_p -> phase -> x_p round trip (~1e-5 px) exceeds, and
    outside the mask too, so its repaired mask grows by background pixels
    (slr/pipeline/reconstruct.py:170-177). The port changes only masked
    pixels moved by more than half a period: its mask never grows."""
    mask_true = noisy_scene[-1]
    for mode in ("voting", "wavefront"):
        bj, cj, bt, ct = _spatial_agrees(noisy_scene, CFG, mode,
                                         PatternConfig(**CFG).fringe_pitch)
        grown = np.asarray(cj.mask & ~bj.mask)
        assert grown.sum() > 5000 and (grown & ~mask_true).mean() > 0.9 * grown.mean()
        assert torch.equal(ct.mask, bt.mask)
