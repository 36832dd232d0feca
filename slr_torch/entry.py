"""Entry points of the port (the counterparts of ``__graft_entry__``).

    forward, (frames,) = entry()          # on the card; entry("cpu") on the CPU
    points, mask = forward(frames)
    dryrun_multichip(4)                   # 4 ranks, one GPU each (NCCL)
    dryrun_multichip(2, device="cpu")     # 2 ranks on the CPU (Gloo)
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

from slr_torch.config import DecodeConfig, PatternConfig, ReconstructConfig
from slr_torch.device import require_device
from slr_torch.pipeline.reconstruct import DenseReconstructor
from slr_torch.synth.render import default_rig, render_scan
from slr_torch.synth.scene import bumps_depth


def entry(device="cuda"):
    """The config-3 dense-scan forward step on a small synthetic scan.
    Returns (forward, (frames,)) for a 256x128 camera, 6 Gray bits +
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


def dryrun_multichip(n_devices: int, device="cuda", backend=None,
                     timeout_s: float = 300.0) -> None:
    """The parallel tier end to end over ``n_devices`` ranks, each a
    subprocess joined through a file store: the mesh (2 map blocks when
    ``n_devices`` is even, the rest pixel tiles), ``sharded_reconstruct``
    with 2 repair sweeps on a small scan, then 2 iterations of
    ``distributed_bundle_adjust`` with rotations other than the identity.
    Ranks on the card take ``cuda:(rank % device_count)`` over NCCL, which
    needs one GPU a rank; ranks that share a card need ``backend="gloo"``.
    Raises if a rank fails, or the job outlives ``timeout_s``."""
    require_device(device)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parents[1]), os.environ.get("PYTHONPATH", "")]))
    with tempfile.TemporaryDirectory() as tmp:
        store = f"file://{Path(tmp) / 'store'}"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "slr_torch.entry", str(r), str(n_devices), store,
             str(device), backend or ""], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(n_devices)]
        try:
            outs = [p.communicate(timeout=timeout_s)[0].decode() for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    bad = [(r, p.returncode, outs[r][-2000:]) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"dryrun_multichip: ranks failed: {bad}")


def _dryrun_rank(rank: int, n: int, store: str, device: str, backend: str) -> None:
    """One rank of ``dryrun_multichip``."""
    import numpy as np
    import torch

    from slr_torch.dist import (
        distributed_bundle_adjust, init_distributed, make_mesh, sharded_reconstruct)
    from slr_torch.geom.se3 import so3_exp

    torch.set_num_threads(1)
    dev = (init_distributed(store, n, rank, backend=backend or None, device=device)
           or require_device(device))
    map_blocks = 2 if n % 2 == 0 and n > 1 else 1
    pixel_tiles = n // map_blocks
    mesh = make_mesh(pixel_tiles=pixel_tiles, map_blocks=map_blocks)

    # stage 1: pixel-tile sharded reconstruction
    CAM_W = 128
    CAM_H = max(16, 8 * pixel_tiles)
    CAM_H -= CAM_H % pixel_tiles
    cam, proj = default_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=128, proj_h=96,
                            baseline=150.0, toe_in_deg=14.0, device=dev)
    cfg = PatternConfig(proj_width=128, proj_height=96, gray_bits=5, phase_steps=4)
    scan = render_scan(cam, proj, bumps_depth(CAM_H, CAM_W, base=480.0, amp=10.0,
                                              device=dev), cfg)
    pts, mask, _, _ = sharded_reconstruct(scan.frames, cam, proj, cfg, DecodeConfig(),
                                          mesh, spatial_iters=2)
    assert tuple(pts.shape) == (CAM_H, CAM_W, 3) and bool(mask.any())

    # stage 2: the distributed Schur BA with rotations other than the
    # identity, so the rotation Jacobians and the off-diagonal blocks run
    rng = np.random.default_rng(0)
    S, K, L = 3, 2, 8 * map_blocks
    f32 = dict(dtype=torch.float32, device=dev)
    R_true = torch.stack([torch.eye(3, **f32)] + [
        so3_exp(torch.tensor(rng.uniform(-0.2, 0.2, 3), **f32)) for _ in range(S - 1)])
    t_true = torch.tensor(rng.uniform(-5, 5, (S, 3)), **f32)
    t_true[0] = 0.0
    X = torch.tensor(rng.uniform(-50, 50, (L, 3)), **f32)
    obs_s = torch.tensor(rng.integers(0, S, (L, K)), device=dev)
    p = torch.einsum("lkij,lki->lkj", R_true[obs_s], X[:, None, :] - t_true[obs_s])
    R0 = torch.stack([R_true[s] @ so3_exp(torch.tensor(rng.normal(0, 0.02, 3), **f32))
                      for s in range(S)])
    R0[0] = torch.eye(3, **f32)
    res = distributed_bundle_adjust(R0, t_true + 0.1, X + 0.5, obs_s, p,
                                    torch.ones(L, K, **f32), mesh, iters=2)
    assert bool(torch.isfinite(res.rms)), res.rms
    if n > 1:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _dryrun_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
