"""Elastic recovery of the distributed BA (port of ``slr/dist/recovery.py``).

Map blocks are independent: landmarks and their observations shard freely.
Recovering from a lost rank is to reload the poses from the BA checkpoint
(``slr_torch.io.save_ba_state``), drop the landmarks that lived on the lost
rank, re-shard the survivors over the remaining mesh and resume.
"""

from __future__ import annotations

import torch

from slr_torch.dist.ba import BAResult, distributed_bundle_adjust
from slr_torch.io.checkpoint import load_ba_state


def reshard_fragments(X, obs_s, obs_p, obs_w, keep_mask, n_blocks: int):
    """Keeps the landmarks where ``keep_mask`` (False: lived on the lost
    rank) and pads them to a multiple of ``n_blocks`` with zero-weight rows,
    which add nothing to the Schur sums. Returns (X, obs_s, obs_p, obs_w)."""
    keep = torch.as_tensor(keep_mask, dtype=torch.bool, device=X.device)
    out = [a[keep] for a in (X, obs_s, obs_p, obs_w)]
    pad = (-out[0].shape[0]) % n_blocks
    if pad:
        out = [torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))]) for a in out]
    return tuple(out)


def resume_ba(checkpoint_path, obs_s, obs_p, obs_w, X, keep_mask, mesh,
              iters: int = 10, damping: float = 1e-6) -> BAResult:
    """Resumes a BA that lost the landmarks marked False in ``keep_mask``:
    the poses from the checkpoint, the surviving structure re-sharded over
    ``mesh`` (possibly smaller than the first), ``iters`` more iterations."""
    R, t, _, _, _ = load_ba_state(checkpoint_path)
    Xs, ss, ps, ws = reshard_fragments(X, obs_s, obs_p, obs_w, keep_mask,
                                       mesh.shape["map_block"])
    return distributed_bundle_adjust(
        torch.as_tensor(R, device=X.device), torch.as_tensor(t, device=X.device),
        Xs, ss, ps, ws, mesh, iters=iters, damping=damping)
