"""The frozen synth renders the program's synth's bits, as the two stand
today (a small camera; config 3's and config 5's scenes and patterns)."""

import torch

from portbench.frozen import synth
from slr_torch.config import PatternConfig
from slr_torch.geom.se3 import so3_exp
from slr_torch.synth import render as prog_render
from slr_torch.synth import scene as prog_scene

W, H = 96, 80
CFG = PatternConfig()


def _rigs():
    return synth.default_rig(W, H), prog_render.default_rig(W, H)


def test_rig_matches():
    (cam, proj), (pcam, pproj) = _rigs()
    for a, b in zip(tuple(cam) + tuple(proj), tuple(pcam) + tuple(pproj)):
        assert torch.equal(a, b)


def test_bumps_scan_matches():
    (cam, proj), (pcam, pproj) = _rigs()
    depth = synth.bumps_depth(H, W, base=483.5, amp=27.25)
    assert torch.equal(depth, prog_scene.bumps_depth(H, W, base=483.5, amp=27.25))
    got = synth.render_scan(cam, proj, depth, 1024, 768, 7, 4, noise_std=0.005,
                            generator=torch.Generator().manual_seed(5))
    want = prog_render.render_scan(pcam, pproj, depth, CFG, noise_std=0.005,
                                   generator=torch.Generator().manual_seed(5))
    assert torch.equal(got.frames, want.frames)
    assert torch.equal(got.points_true, want.points_true)
    assert torch.equal(got.mask_true, want.mask_true)
    assert torch.equal(synth.quantize_u8(got.frames), prog_render.quantize_frames(want.frames))


def test_orbit_scan_matches():
    (cam, proj), (pcam, pproj) = _rigs()
    s = 3
    phi = torch.tensor([0.0, 0.025, 0.008]) * s
    R_m = synth.so3_exp(phi)
    assert torch.equal(R_m, so3_exp(torch.tensor([0.0, 0.025 * s, 0.008 * s])))
    t_m = torch.tensor([7.0, -3.0, 0.0]) * s
    cam_s, proj_s = synth.move_rig(cam, proj, R_m, t_m)
    pcam_s, pproj_s = prog_render.move_rig(pcam, pproj, R_m, t_m)
    depth = synth.rocks_scene(cam_s, H, W)
    assert torch.equal(depth, prog_scene.rocks_scene(pcam_s, H, W))
    got = synth.render_scan(cam_s, proj_s, depth, 1024, 768, 7, 4, noise_std=0.003,
                            generator=torch.Generator().manual_seed(41))
    want = prog_render.render_scan(pcam_s, pproj_s, depth, CFG, noise_std=0.003,
                                   generator=torch.Generator().manual_seed(41))
    assert torch.equal(got.frames, want.frames)
    assert torch.equal(got.points_true, want.points_true)
