"""The port's CUDA kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
"""

import pytest
import torch

from slr_torch.config import DecodeConfig, PatternConfig
from slr_torch.kernels import fused_scan as fs
from slr_torch.pipeline.reconstruct import DenseReconstructor, accumulate_by_projector
from slr_torch.synth.render import default_rig, render_scan
from slr_torch.synth.scene import bumps_depth

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _scan(device, w, h, noise):
    cam, proj = default_rig(cam_w=w, cam_h=h, proj_w=256, proj_h=192,
                            baseline=150.0, toe_in_deg=14.0, device=device)
    cfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=6,
                        phase_steps=4)
    gen = torch.Generator(device=device).manual_seed(1)
    scan = render_scan(cam, proj, bumps_depth(h, w, base=480.0, amp=25.0,
                                              device=device),
                       cfg, noise_std=noise, generator=gen)
    return cam, proj, cfg, scan


@pytest.mark.parametrize("w,h,noise", [(320, 256, 0.005), (300, 215, 0.0)])
def test_kernel_matches_plain_version(cuda, w, h, noise):
    cam, proj, cfg, scan = _scan(cuda, w, h, noise)
    dec = DecodeConfig()
    before = fs.fused_decode_triangulate.launches
    k = fs.fused_decode_triangulate(scan.frames, cam, proj, cfg, dec)
    assert fs.fused_decode_triangulate.launches == before + 1
    p = fs.fused_decode_triangulate_reference(scan.frames, cam, proj, cfg, dec)
    torch.cuda.synchronize()
    mk, mp = k.mask > 0.5, p.mask > 0.5
    # FMA contraction, sum order and the device atan2f can flip a code bit
    # only on pixels sitting exactly on a code edge: bound fractions
    assert float((mk ^ mp).float().mean()) <= 1e-3
    both = mk & mp
    assert float(both.float().mean()) > 0.3
    dx = (k.x_p - p.x_p).abs()
    assert float((both & (dx > 1e-3)).sum()) <= 1e-4 * float(both.sum())
    agree = both & (dx <= 1e-3)
    assert float((k.points - p.points).abs().amax(0)[agree].max()) <= 1e-2
    assert float((k.quality - p.quality).abs().max()) <= 1e-5
    assert float(k.y_p.abs().max()) == 0.0
    assert not bool(torch.isnan(k.points).any())


def test_dense_reconstructor_launches_kernel_once(cuda):
    cam, proj, cfg, scan = _scan(torch.device("cpu"), 320, 256, 0.0)
    model = DenseReconstructor(cam, proj, cfg).to(cuda)
    frames = scan.frames.to(cuda)
    fs.fused_decode_triangulate.launches = 0
    cloud = model(frames)
    torch.cuda.synchronize()
    assert fs.fused_decode_triangulate.launches == 1
    valid = cloud.mask.cpu() & scan.mask_true
    err = torch.linalg.norm(cloud.points.cpu() - scan.points_true, dim=-1)[valid]
    assert float(err.square().mean().sqrt()) < 0.5
    # index_add_ on the card sums with atomics in a varying order:
    # relative 1e-5 against the CPU's sums of the same cloud
    on_card = accumulate_by_projector(cloud, 256)
    on_cpu = accumulate_by_projector(type(cloud)(*(x.cpu() for x in cloud)), 256)
    assert torch.equal(on_card[1].cpu(), on_cpu[1])
    for a, b in ((on_card[0], on_cpu[0]), (on_card[2], on_cpu[2])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


def test_kernel_rejects_bad_input(cuda):
    cam, proj, cfg, scan = _scan(cuda, 64, 48, 0.0)
    params = fs.scan_params(cam, proj, cfg, DecodeConfig(), (1.0, 1e4), 8, 48, 64)
    with pytest.raises(ValueError, match="contiguous"):
        fs.launch_fused_scan(scan.frames.transpose(1, 2), params)
    with pytest.raises(ValueError, match="do not match"):
        fs.launch_fused_scan(scan.frames[:, :40].contiguous(), params)
