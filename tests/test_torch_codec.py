"""slr_torch codec against the JAX reference (CPU).

Pattern generation, Gray/phase decode, temporal unwrap and the unfused
``decode_stack`` on one rendered 320x256 scan, fed to both packages as the
same numpy frames (float32 and uint8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slr.codec as jc
from slr.config import DecodeConfig as JDecodeConfig
from slr.config import PatternConfig as JPatternConfig
from slr.synth import bumps_depth
from slr.synth.render import default_rig, render_scan
from slr_torch.codec import graycode as tg
from slr_torch.codec import multifreq as tmf
from slr_torch.codec import patterns as tp
from slr_torch.codec import phaseshift as tph
from slr_torch.codec import unwrap as tu
from slr_torch.config import DecodeConfig, PatternConfig
from slr_torch.synth.render import quantize_frames

torch.set_num_threads(2)

CAM_W, CAM_H = 320, 256
CFG = dict(proj_width=256, proj_height=192, gray_bits=6, phase_steps=4)


@pytest.fixture(scope="module")
def frames_np():
    """Noiseless JAX render + seeded numpy sensor noise, clipped as
    slr.synth.render does."""
    cam, proj = default_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=256, proj_h=192,
                            baseline=150.0, toe_in_deg=14.0)
    depth = bumps_depth(CAM_H, CAM_W, base=480.0, amp=25.0)
    scan = render_scan(cam, proj, depth, JPatternConfig(**CFG))
    frames = np.array(scan.frames)
    noise = np.random.default_rng(1).standard_normal(frames.shape)
    return np.clip(frames + 0.005 * noise.astype(np.float32), 0, 1).astype(np.float32)


@pytest.mark.parametrize("kw", [
    CFG,
    dict(proj_width=1024, proj_height=768, gray_bits=7, phase_steps=4),
    dict(proj_width=200, proj_height=150, gray_bits=5, phase_steps=3,
         row_gray_bits=4, row_phase_steps=3),
    dict(proj_width=256, proj_height=192, gray_bits=6, phase_steps=0,
         use_inverse=False),
    dict(proj_width=256, proj_height=192, coding="multifreq", phase_steps=4,
         mf_levels=3, mf_ratio=6.0),
])
def test_pattern_stack_matches_reference(kw):
    # JAX run eagerly: under jit XLA fuses the fringe cos differently
    # (~1e-5), eagerly both are libm-accurate float32
    a = np.asarray(jc.generate_pattern_stack(JPatternConfig(**kw)))
    b = tp.generate_pattern_stack(PatternConfig(**kw)).numpy()
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1e-6


@pytest.mark.parametrize("half_shift", [False, True])
@pytest.mark.parametrize("width,bits", [(256, 6), (200, 5), (1024, 7)])
def test_gray_patterns_and_codes_match_reference(width, bits, half_shift):
    for aa in (False, True):
        a = np.asarray(jc.generate_gray_patterns(width, bits, half_shift, aa))
        b = tg.generate_gray_patterns(width, bits, half_shift, aa).numpy()
        np.testing.assert_array_equal(a, b)
    n = np.arange(1 << bits, dtype=np.int32)
    g = np.asarray(jc.gray_encode(n))
    np.testing.assert_array_equal(tg.gray_encode(torch.from_numpy(n)).numpy(), g)
    np.testing.assert_array_equal(
        tg.gray_decode_int(torch.tensor(g), bits).numpy(), n)


def test_decode_gray_phase_unwrap_match_reference(frames_np):
    cfg = PatternConfig(**CFG)
    s = tp._slices(cfg)
    ft = torch.from_numpy(frames_np)
    fj = jnp.asarray(frames_np)
    (a, b), (ai, bi), (pa, pb) = s["col"], s["col_inv"], s["phase"]

    code_j, mask_j = jc.decode_gray(fj[a:b], fj[ai:bi], fj[0], fj[1], 6)
    code_t, mask_t = tg.decode_gray(ft[a:b], ft[ai:bi], ft[0], ft[1], 6)
    assert code_t.dtype == torch.int32 and mask_t.dtype == torch.bool
    np.testing.assert_array_equal(code_t.numpy(), np.asarray(code_j))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))

    phi_j, B_j = jc.decode_phase(fj[pa:pb], 4)
    phi_t, B_t = tph.decode_phase(ft[pa:pb], 4)
    # float32 sums in another order and libm atan2: a few ulps
    np.testing.assert_allclose(B_t.numpy(), np.asarray(B_j), atol=1e-6)
    dphi = np.abs(phi_t.numpy() - np.asarray(phi_j))
    dphi = np.minimum(dphi, 2 * np.pi - dphi)  # phi near 0 may wrap to ~2pi
    assert dphi.max() < 1e-5

    for half in (True, False):
        Pj = jc.unwrap_temporal(phi_j, code_j, 6, half_shifted=half)
        Pt = tu.unwrap_temporal(torch.tensor(np.asarray(phi_j)), code_t,
                                6, half_shifted=half)
        np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_decode_stack_matches_reference(frames_np, dtype):
    f = frames_np
    if dtype == "uint8":
        f = np.asarray(quantize_frames(torch.from_numpy(frames_np)))
        assert f.dtype == np.uint8
    rj = jc.decode_stack(jnp.asarray(f), JPatternConfig(**CFG), JDecodeConfig())
    rt = tp.decode_stack(torch.from_numpy(f), PatternConfig(**CFG), DecodeConfig())
    mj, mt = np.asarray(rj.mask), rt.mask.numpy()
    assert rt.y_p is None and mt.dtype == bool
    # float32 ulps in the phase sums can flip the gates only on pixels
    # sitting exactly on a threshold
    assert (mj != mt).mean() <= 1e-3
    assert mt.mean() > 0.4
    both = mj & mt
    dx = np.abs(np.asarray(rj.x_p) - rt.x_p.numpy())[both]
    assert (dx > 1e-3).mean() <= 1e-4, dx.max()
    np.testing.assert_allclose(rt.quality.numpy(), np.asarray(rj.quality), atol=1e-5)


def test_decode_stack_row_codes_match_reference():
    kw = dict(proj_width=256, proj_height=192, gray_bits=6, phase_steps=4,
              row_gray_bits=5, row_phase_steps=4)
    cam, proj = default_rig(cam_w=160, cam_h=128, proj_w=256, proj_h=192,
                            baseline=150.0, toe_in_deg=14.0)
    scan = render_scan(cam, proj, bumps_depth(128, 160, base=480.0, amp=20.0),
                       JPatternConfig(**kw))
    f = np.array(scan.frames)
    rj = jc.decode_stack(jnp.asarray(f), JPatternConfig(**kw), JDecodeConfig())
    rt = tp.decode_stack(torch.from_numpy(f), PatternConfig(**kw), DecodeConfig())
    mj, mt = np.asarray(rj.mask), rt.mask.numpy()
    assert (mj != mt).mean() <= 1e-3 and mt.mean() > 0.3
    both = mj & mt
    for a, b in ((rj.x_p, rt.x_p), (rj.y_p, rt.y_p)):
        d = np.abs(np.asarray(a) - b.numpy())[both]
        assert (d > 1e-3).mean() <= 1e-4, d.max()


MF = dict(proj_width=256, proj_height=192, coding="multifreq", phase_steps=4,
          mf_levels=3, mf_ratio=6.0)


@pytest.fixture(scope="module")
def multifreq_np():
    """Noiseless JAX multifreq render + seeded numpy noise, clipped."""
    cam, proj = default_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=256, proj_h=192,
                            baseline=150.0, toe_in_deg=14.0)
    scan = render_scan(cam, proj, bumps_depth(CAM_H, CAM_W, base=480.0, amp=25.0),
                       JPatternConfig(**MF))
    frames = np.array(scan.frames)
    noise = np.random.default_rng(4).standard_normal(frames.shape)
    return np.clip(frames + 0.005 * noise.astype(np.float32), 0, 1).astype(np.float32)


def test_multifreq_stack_matches_reference():
    from slr.codec import multifreq as jmf

    assert tmf.default_pitches(1024) == jmf.default_pitches(1024)
    assert tmf.default_pitches(256, 3, 6.0) == jmf.default_pitches(256, 3, 6.0)
    pitches = jmf.default_pitches(256, 3, 6.0)
    a = np.asarray(jmf.generate_multifreq_stack(256, 192, pitches, steps=4))
    b = tmf.generate_multifreq_stack(256, 192, pitches, steps=4).numpy()
    assert a.shape == b.shape == (14, 192, 256)
    assert np.abs(a - b).max() <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_decode_multifreq_matches_reference(multifreq_np, dtype):
    """decode_multifreq itself, and decode_stack's multifreq branch."""
    from slr.codec import multifreq as jmf

    f = multifreq_np
    if dtype == "uint8":
        f = np.asarray(quantize_frames(torch.from_numpy(f)))
    cfg = PatternConfig(**MF)
    rj = jc.decode_stack(jnp.asarray(f), JPatternConfig(**MF), JDecodeConfig())
    rt = tp.decode_stack(torch.from_numpy(f), cfg, DecodeConfig())
    assert rt.y_p is None
    xj, mj, qj = jmf.decode_multifreq(jnp.asarray(multifreq_np), cfg.mf_pitches, 4)
    xt, mt, qt = tmf.decode_multifreq(torch.from_numpy(multifreq_np), cfg.mf_pitches, 4)
    for a, b in (((rj.x_p, rj.mask, rj.quality), (rt.x_p, rt.mask, rt.quality)),
                 ((xj, mj, qj), (xt, mt, qt))):
        mj_, mt_ = np.asarray(a[1]), b[1].numpy()
        assert (mj_ != mt_).mean() <= 1e-3 and mt_.mean() > 0.4
        both = mj_ & mt_
        d = np.abs(np.asarray(a[0]) - b[0].numpy())[both]
        assert (d > 1e-3).mean() <= 1e-4, d.max()
        np.testing.assert_allclose(b[2].numpy(), np.asarray(a[2]), atol=1e-5)


def test_generate_phase_patterns_match_reference():
    for width, pitch, steps in ((256, 4.0, 4), (1024, 8.0, 4), (300, 9.375, 3)):
        a = np.asarray(jc.generate_phase_patterns(width, pitch, steps))
        b = tph.generate_phase_patterns(width, pitch, steps).numpy()
        assert np.abs(a - b).max() <= 1e-6
