"""slr_torch exposure brackets against the JAX reference (CPU).

K2's plain version (``fused_decode_triangulate_hdr_reference``) against
``slr.kernels.fused_scan.fused_decode_triangulate_hdr`` in Pallas interpret
mode, ``decode_multi_exposure`` and ``reconstruct_scan_hdr`` (both of its
routes) against theirs, on the same numpy brackets. The scenes are 160x128:
the JAX package's own HDR kernel tests at 320x256 are marked slow.

Tolerances: those of tests/test_torch_fused_scan.py, for the same reasons
(rare code-edge flips from ulp-level differences). The fused phase sums are
taken in the kernel's order (sum of B*S over sum of B) rather than JAX's
(sum of (B / sum B) * S); the two differ by float32 rounding, inside those
tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import box_exposures, hdr_best_exposure, k2_box
from slr.codec import decode_multi_exposure as jax_decode_multi_exposure
from slr.config import DecodeConfig as JDecodeConfig
from slr.config import PatternConfig as JPatternConfig
from slr.kernels.fused_scan import fused_decode_triangulate_hdr as jax_hdr
from slr.pipeline import reconstruct as jrec
from slr.synth import bumps_depth, checker_albedo
from slr.synth.render import default_rig, render_scan
from slr_torch import observability as obs
from slr_torch.codec.exposure import decode_multi_exposure
from slr_torch.config import DecodeConfig, PatternConfig
from slr_torch.geom.camera import camera_from_numpy
from slr_torch.kernels import fused_scan as fs
from slr_torch.pipeline import reconstruct as trec

torch.set_num_threads(2)


def _launches(*kernels):
    """The launches so far of each kernel ("k1" .. "k8"), from the
    recorder's ``launches.*`` counters; of one kernel, a number."""
    counts = obs.snapshot().counts
    got = tuple(counts.get(f"launches.{k}", 0) for k in kernels)
    return got[0] if len(got) == 1 else got

W, H = 160, 128
CFG = dict(proj_width=256, proj_height=192, gray_bits=5, phase_steps=4)
GAINS = {2: (1.0, 10.0), 3: (1.0, 3.2, 10.0)}


def _bracket(E, kw=CFG, seed=3, cells=6):
    """JAX render of a 21x-albedo checkerboard of ``cells`` squares a row,
    noiseless; E independent captures at the bracket's gains with seeded
    numpy noise, quantized to uint8 (as the reference benchmark builds its
    bracket)."""
    cam, proj = default_rig(cam_w=W, cam_h=H, proj_w=256, proj_h=192)
    albedo = checker_albedo(H, W, cells=cells, lo=0.035, hi=0.75)
    scan = render_scan(cam, proj, bumps_depth(H, W, base=480.0, amp=25.0),
                       JPatternConfig(**kw), albedo=albedo)
    f = np.array(scan.frames)
    rng = np.random.default_rng(seed)
    bracket = np.stack([
        np.clip(f * g + 0.003 * rng.standard_normal(f.shape).astype(np.float32), 0, 1)
        for g in GAINS[E]]).astype(np.float32)
    bracket = np.clip(np.round(bracket * 255), 0, 255).astype(np.uint8)
    as_t = lambda c: camera_from_numpy(jax.tree.map(np.asarray, c))  # noqa: E731
    return cam, proj, as_t(cam), as_t(proj), bracket, scan


def _agrees(mask_a, mask_b, xp_a, xp_b, pts_a, pts_b, q_a, q_b):
    assert (mask_a != mask_b).mean() <= 1e-3
    both = mask_a & mask_b
    assert both.mean() > 0.3
    dx = np.abs(xp_a - xp_b)
    assert (dx[both] > 1e-3).mean() <= 1e-4, dx[both].max()
    agree = both & (dx <= 1e-3)
    assert np.abs(pts_a - pts_b)[..., agree].max() <= 1e-2
    assert np.abs(q_a - q_b).max() <= 1e-5


@pytest.mark.parametrize("fuse", ["sum", "select"])
@pytest.mark.parametrize("E", [2, 3])
def test_hdr_plain_version_matches_jax_kernel(E, fuse):
    camj, projj, cam, proj, bracket, _ = _bracket(E)
    oj = jax_hdr(jnp.asarray(bracket), camj, projj, JPatternConfig(**CFG),
                 JDecodeConfig(), fuse=fuse)
    ot = fs.fused_decode_triangulate_hdr(torch.from_numpy(bracket), cam, proj,
                                         PatternConfig(**CFG), DecodeConfig(),
                                         fuse=fuse)
    assert tuple(ot.points.shape) == (3, H, W)
    assert all(x.dtype == torch.float32 for x in ot)
    _agrees(np.asarray(oj.mask) > 0.5, ot.mask.numpy() > 0.5,
            np.asarray(oj.x_p), ot.x_p.numpy(), np.asarray(oj.points),
            ot.points.numpy(), np.asarray(oj.quality), ot.quality.numpy())
    np.testing.assert_array_equal(ot.y_p.numpy(), 0.0)


@pytest.mark.parametrize("fuse", ["sum", "select"])
def test_hdr_plain_version_on_mixed_boxes(fuse):
    """A checkerboard of ~3 px squares, so the chosen exposure changes inside
    most of the 128 x 2 boxes K2 stages (each then stages the Gray frames of
    several exposures): the plain version against the JAX kernel. The best
    exposure map (``hdr_best_exposure``, an argmax) is the plain version's
    own choice: under ``select`` each pixel's quality is that exposure's
    modulation alone, bit for bit."""
    camj, projj, cam, proj, bracket, _ = _bracket(3, cells=W // 3)
    cfg, dec = PatternConfig(**CFG), DecodeConfig()
    bt = torch.from_numpy(bracket)
    best = hdr_best_exposure(bt, cfg, dec)
    box_h, box_w = k2_box()
    chosen = box_exposures(best, 3, (box_h, box_w))
    assert chosen.shape == (H // box_h, W // box_w)
    assert float((chosen >= 2).float().mean()) > 0.5
    oj = jax_hdr(jnp.asarray(bracket), camj, projj, JPatternConfig(**CFG),
                 JDecodeConfig(), fuse=fuse)
    ot = fs.fused_decode_triangulate_hdr(bt, cam, proj, cfg, dec, fuse=fuse)
    _agrees(np.asarray(oj.mask) > 0.5, ot.mask.numpy() > 0.5,
            np.asarray(oj.x_p), ot.x_p.numpy(), np.asarray(oj.points),
            ot.points.numpy(), np.asarray(oj.quality), ot.quality.numpy())
    if fuse == "select":
        single = torch.stack([fs.fused_decode_triangulate_hdr(
            bt[e:e + 1], cam, proj, cfg, dec, fuse=fuse).quality for e in range(3)])
        assert torch.equal(ot.quality, single.gather(0, best[None])[0])


def test_hdr_plain_version_on_float_brackets_and_rows():
    """float32 brackets (float thresholds, float saturation) and row codes
    with row phase (midpoint geometry), against the JAX kernel."""
    kw = dict(CFG, row_gray_bits=5, row_phase_steps=4)
    camj, projj, cam, proj, bracket, _ = _bracket(2, kw)
    fb = (bracket.astype(np.float32) / 255.0).astype(np.float32)
    oj = jax_hdr(jnp.asarray(fb), camj, projj, JPatternConfig(**kw), JDecodeConfig())
    ot = fs.fused_decode_triangulate_hdr(torch.from_numpy(fb), cam, proj,
                                         PatternConfig(**kw), DecodeConfig())
    _agrees(np.asarray(oj.mask) > 0.5, ot.mask.numpy() > 0.5,
            np.asarray(oj.x_p), ot.x_p.numpy(), np.asarray(oj.points),
            ot.points.numpy(), np.asarray(oj.quality), ot.quality.numpy())
    both = (np.asarray(oj.mask) > 0.5) & (ot.mask.numpy() > 0.5)
    dy = np.abs(np.asarray(oj.y_p) - ot.y_p.numpy())[both]
    assert (dy > 1e-3).mean() <= 1e-4


@pytest.mark.parametrize("fuse", ["sum", "select"])
def test_hdr_bracket_accuracy_and_coverage(fuse):
    """Sub-mm against the ground truth, and the bracket decodes far more
    pixels than its best single exposure under the same gates."""
    _, _, cam, proj, bracket, scan = _bracket(3)
    cfg, dec = PatternConfig(**CFG), DecodeConfig()
    bt = torch.from_numpy(bracket)
    out = fs.fused_decode_triangulate_hdr(bt, cam, proj, cfg, dec, fuse=fuse)
    m = out.mask.numpy() > 0.5
    valid = m & np.asarray(scan.mask_true)
    err = np.linalg.norm(out.points.numpy().transpose(1, 2, 0)
                         - np.asarray(scan.points_true), axis=-1)[valid]
    assert np.sqrt(np.mean(err ** 2)) < 0.5
    single = max(int((fs.fused_decode_triangulate_hdr(bt[e:e + 1], cam, proj, cfg,
                                                      dec).mask > 0.5).sum())
                 for e in range(3))
    assert m.sum() > 1.3 * single


@pytest.mark.parametrize("E", [2, 3])
def test_decode_multi_exposure_matches_reference(E):
    _, _, _, _, bracket, _ = _bracket(E)
    rj = jax_decode_multi_exposure(jnp.asarray(bracket), JPatternConfig(**CFG),
                                   JDecodeConfig())
    rt = decode_multi_exposure(torch.from_numpy(bracket), PatternConfig(**CFG),
                               DecodeConfig())
    mj, mt = np.asarray(rj.mask), rt.mask.numpy()
    assert rt.y_p is None and mt.dtype == bool
    assert (mj != mt).mean() <= 1e-3 and mt.mean() > 0.3
    both = mj & mt
    dx = np.abs(np.asarray(rj.x_p) - rt.x_p.numpy())[both]
    assert (dx > 1e-3).mean() <= 1e-4
    np.testing.assert_allclose(rt.quality.numpy(), np.asarray(rj.quality), atol=1e-5)


def test_argmax_breaks_ties_like_jnp():
    """decode_multi_exposure relies on torch.argmax taking the first of
    equal scores, as jnp.argmax does."""
    rng = np.random.default_rng(0)
    scores = rng.integers(-1, 3, size=(4, 64, 64)).astype(np.float32)  # many ties
    np.testing.assert_array_equal(torch.argmax(torch.from_numpy(scores), dim=0).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(scores), axis=0)))


@pytest.mark.parametrize("route,kw", [
    ("kernel", CFG),
    ("decode_multi_exposure_multifreq",
     dict(proj_width=256, proj_height=192, coding="multifreq", phase_steps=4,
          mf_levels=3, mf_ratio=6.0)),
    ("decode_multi_exposure_gray_only",
     dict(proj_width=256, proj_height=192, gray_bits=6, phase_steps=0)),
])
def test_reconstruct_scan_hdr_matches_reference(route, kw):
    camj, projj, cam, proj, bracket, _ = _bracket(2, kw)
    cj = jrec.reconstruct_scan_hdr(jnp.asarray(bracket), camj, projj,
                                   JPatternConfig(**kw))
    cfg = PatternConfig(**kw)
    ct = trec.reconstruct_scan_hdr(torch.from_numpy(bracket), cam, proj, cfg)
    assert ct.points.shape == (H, W, 3) and ct.mask.dtype == torch.bool
    _agrees(np.asarray(cj.mask), ct.mask.numpy(), np.asarray(cj.x_p),
            ct.x_p.numpy(), np.moveaxis(np.asarray(cj.points), -1, 0),
            ct.points.permute(2, 0, 1).numpy(), np.asarray(cj.quality),
            ct.quality.numpy())
    # XLA turns the jitted division by 255 into a product with 1/255: 1 ulp
    np.testing.assert_allclose(ct.colors.numpy(), np.asarray(cj.colors),
                               rtol=0, atol=6e-8)
    # a CPU bracket takes K2's plain version on the kernel route only
    before = _launches("k2")
    model = trec.DenseReconstructor(cam, proj, cfg)
    for a, b in zip(model(torch.from_numpy(bracket)), ct):
        assert torch.equal(a, b)
    assert _launches("k2") == before


@pytest.mark.parametrize("kind", ["phase_steps=0", "multifreq", "no_inverse",
                                  "3-D input", "fuse"])
def test_hdr_refuses_outside_contract(kind):
    cfg = PatternConfig(**CFG)
    if kind == "phase_steps=0":
        cfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=5,
                            phase_steps=0)
    elif kind == "multifreq":
        cfg = PatternConfig(proj_width=256, proj_height=192, coding="multifreq")
    elif kind == "no_inverse":
        cfg = PatternConfig(**CFG, use_inverse=False)
    stacks = torch.zeros((2, cfg.num_frames, 8, 8), dtype=torch.uint8)
    if kind == "3-D input":
        stacks = stacks[0]
    from slr_torch.synth.render import default_rig as rig

    cam, proj = rig(cam_w=8, cam_h=8, proj_w=256, proj_h=192)
    fuse = "mean" if kind == "fuse" else "sum"
    match = {"3-D input": r"\(E, F, H, W\)", "fuse": "fuse must be"}.get(
        kind, "gray_phase coding with inverse patterns and phase_steps > 0")
    for fn in (fs.fused_decode_triangulate_hdr,
               fs.fused_decode_triangulate_hdr_reference):
        with pytest.raises(ValueError, match=match):
            fn(stacks, cam, proj, cfg, DecodeConfig(), fuse=fuse)


def test_hdr_phase_fusion_beats_selection():
    """The port's K2 (plain version) on the JAX package's overlapping-ladder
    scene (tests/test_kernels.py::test_hdr_phase_fusion_beats_selection):
    dark cells usable in all three exposures pool their signal under
    fuse="sum", so their RMS falls well below fuse="select"'s; overall
    never worse, coverage unchanged. Its own numpy noise draw."""
    cam, proj = default_rig(cam_w=320, cam_h=256, proj_w=256, proj_h=192)
    albedo = checker_albedo(256, 320, cells=6, lo=0.08, hi=0.45)
    scan = render_scan(cam, proj, bumps_depth(256, 320, base=480.0, amp=25.0),
                       JPatternConfig(**CFG), albedo=albedo)
    f = np.array(scan.frames)
    rng = np.random.default_rng(7)
    bracket = np.stack([
        np.clip(f * g + 0.004 * rng.standard_normal(f.shape).astype(np.float32), 0, 1)
        for g in (2.0, 3.0, 4.5)])
    bracket = torch.from_numpy(np.clip(np.round(bracket * 255), 0, 255).astype(np.uint8))
    as_t = lambda c: camera_from_numpy(jax.tree.map(np.asarray, c))  # noqa: E731
    dark = np.asarray(albedo) < 0.2

    def rms_of(fuse):
        out = fs.fused_decode_triangulate_hdr(bracket, as_t(cam), as_t(proj),
                                              PatternConfig(**CFG), DecodeConfig(),
                                              fuse=fuse)
        m = (out.mask.numpy() > 0.5) & np.asarray(scan.mask_true)
        err = np.linalg.norm(out.points.numpy().transpose(1, 2, 0)
                             - np.asarray(scan.points_true), axis=-1)
        return (float(np.sqrt(np.mean(err[m & dark] ** 2))),
                float(np.sqrt(np.mean(err[m] ** 2))), int(m.sum()))

    dark_sum, rms_sum, n_sum = rms_of("sum")
    dark_sel, rms_sel, n_sel = rms_of("select")
    assert dark_sum < 0.92 * dark_sel, (dark_sum, dark_sel)
    assert rms_sum <= rms_sel * 1.02, (rms_sum, rms_sel)
    assert n_sum >= 0.98 * n_sel, (n_sum, n_sel)
