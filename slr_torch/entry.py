"""Entry point of the port: the config-3 dense-scan forward step on a small
synthetic scan (the counterpart of ``__graft_entry__.entry``).

    forward, (frames,) = entry()          # on the card; entry("cpu") on the CPU
    points, mask = forward(frames)
"""

from __future__ import annotations

from slr_torch.config import DecodeConfig, PatternConfig, ReconstructConfig
from slr_torch.device import require_device
from slr_torch.pipeline.reconstruct import DenseReconstructor
from slr_torch.synth.render import default_rig, render_scan
from slr_torch.synth.scene import bumps_depth


def entry(device="cuda"):
    """Returns (forward, (frames,)) for a 256x128 camera, 6 Gray bits +
    4-step phase, with the rig and frames on ``device``: the card unless
    the caller asks for the CPU (``entry("cpu")``). Raises when asked for
    the card and there is none."""
    device = require_device(device)
    CAM_W, CAM_H = 256, 128
    cam, proj = default_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=256, proj_h=192,
                            baseline=150.0, toe_in_deg=14.0, device=device)
    cfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=6,
                        phase_steps=4)
    depth = bumps_depth(CAM_H, CAM_W, base=480.0, amp=20.0, device=device)
    scan = render_scan(cam, proj, depth, cfg)
    model = DenseReconstructor(cam, proj, cfg, DecodeConfig(),
                               ReconstructConfig())

    def forward(frames):
        cloud = model(frames)
        return cloud.points, cloud.mask

    return forward, (scan.frames,)
