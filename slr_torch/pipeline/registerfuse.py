"""Multi-scan registration (config 4; port of ``slr/pipeline/registerfuse.py``).

``register_scans``: sequential pairwise alignment (point-to-plane ICP, raced
against an FPFH + RANSAC-initialised ICP, with a projective polish when the
rig camera is given) into a pose chain, loop-closure edges, then pose-graph
refinement over every relative measurement. ``register_scans_batched``,
``ba_refine`` and ``fuse_scans`` are ROADMAP slice 6.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from slr_torch.config import RegistrationConfig
from slr_torch.pipeline.reconstruct import ScanCloud
from slr_torch.registration.features import fpfh_features, ransac_align
from slr_torch.registration.icp import icp_point_to_plane
from slr_torch.registration.normals import grid_normals
from slr_torch.registration.posegraph import pose_graph_optimize
from slr_torch.registration.projective import icp_projective


class RegisteredScans(NamedTuple):
    R: torch.Tensor          # (S,3,3) scan -> anchor (world) rotations
    t: torch.Tensor          # (S,3)
    icp_rms: torch.Tensor    # (S-1,) pairwise ICP residuals
    pg_rms: torch.Tensor     # pose-graph residual RMS


def _draw_samples(p, n: int, seed: int):
    """``n`` pixel indices drawn with replacement with probabilities ``p``
    (the counterpart of the reference's ``jax.random.choice(key, H*W, (n,),
    p=p)``; a test may substitute the JAX draw)."""
    g = torch.Generator(device=p.device).manual_seed(seed)
    return torch.multinomial(p, n, replacement=True, generator=g)


def _subsample(cloud: ScanCloud, n: int, seed: int = 0, min_incidence: float = 0.35):
    """Fixed-size random draw of valid points, with replacement (duplicates
    are harmless for ICP and features). Grazing-incidence points
    (|normal . viewdir| below ``min_incidence``) are excluded: their depth
    error is amplified by 1/cos and they bias ICP. Returns (points, normals)."""
    normals = grid_normals(cloud.points, cloud.mask)
    vdir = cloud.points / (torch.linalg.norm(cloud.points, dim=-1, keepdim=True) + 1e-9)
    cos_inc = torch.abs(torch.sum(normals * vdir, dim=-1))
    p = (cloud.mask & (cos_inc > min_incidence)).reshape(-1).to(torch.float32)
    idx = _draw_samples(p / torch.sum(p), n, seed)
    return cloud.points.reshape(-1, 3)[idx], normals.reshape(-1, 3)[idx]


def register_scans(
    clouds: List[ScanCloud],
    cfg: RegistrationConfig = RegistrationConfig(),
    use_features: bool = True,
    cam=None,
    loop_closures: bool = True,
) -> RegisteredScans:
    """Align scan s to scan s-1 pairwise, accumulate the chain, add
    loop-closure edges (last <-> first and skip pairs), then refine all
    poses jointly on the pose graph. Scan 0 is the anchor.

    With the rig camera, each fine alignment ends with a dense projective
    polish on the organized grids. A closure candidate is aligned from the
    chain-predicted relative pose and kept only when ICP locks (inlier
    fraction >= 0.3). The accept/reject decisions read results on the host.
    """
    S = len(clouds)
    samples = [_subsample(c, cfg.icp_sample_points, seed=i)
               for i, c in enumerate(clouds)]
    grids = None
    if cam is not None:
        grids = [(c.points, c.mask, grid_normals(c.points, c.mask)) for c in clouds]

    def fine_align(s, tgt, R0=None, t0=None):
        """NN ICP for the wide basin, then (with the camera) the projective
        polish, the most accurate finisher from a good start."""
        src_pts, _ = samples[s]
        tgt_pts, tgt_nrm = samples[tgt]
        res = icp_point_to_plane(src_pts, tgt_pts, tgt_nrm, R0=R0, t0=t0,
                                 iters=cfg.icp_iters,
                                 max_corr_dist=cfg.icp_max_corr_dist)
        if grids is not None:
            tg, tm, tn = grids[tgt]
            res = icp_projective(
                src_pts, torch.ones(src_pts.shape[0], dtype=torch.bool,
                                    device=src_pts.device),
                tg, tm, tn, cam, R0=res.R, t0=res.t,
                iters=max(8, cfg.icp_iters // 2), max_corr_dist=cfg.icp_max_corr_dist)
        return res

    def feature_align(s, tgt, res):
        """Race an FPFH + RANSAC-initialised ICP against ``res`` and keep
        whichever locked on (features rescue motions beyond the identity
        basin, but are ambiguous on plane-dominated scenes)."""
        src_pts, src_nrm = samples[s]
        tgt_pts, tgt_nrm = samples[tgt]
        R0, t0, _ = ransac_align(src_pts, fpfh_features(src_pts, src_nrm),
                                 tgt_pts, fpfh_features(tgt_pts, tgt_nrm),
                                 n_iters=cfg.ransac_iters,
                                 inlier_dist=cfg.ransac_inlier_dist)
        res_f = fine_align(s, tgt, R0=R0, t0=t0)
        fi, ri = float(res_f.inlier_frac), float(res.inlier_frac)
        better = fi > ri or (abs(fi - ri) < 0.05 and float(res_f.rms) < float(res.rms))
        return res_f if better else res

    edges, Zr, Zt, rms_list = [], [], [], []
    for s in range(1, S):
        res = fine_align(s, s - 1)
        if use_features:
            res = feature_align(s, s - 1, res)
        edges.append((s - 1, s))
        Zr.append(res.R)    # measurement: T_{s-1}^-1 T_s (src -> tgt)
        Zt.append(res.t)
        rms_list.append(res.rms)

    # chain odometry init
    dev = clouds[0].points.device
    R_init = [torch.eye(3, device=dev)]
    t_init = [torch.zeros(3, device=dev)]
    for s in range(1, S):
        R_init.append(R_init[-1] @ Zr[s - 1])
        t_init.append(R_init[-2] @ Zt[s - 1] + t_init[-1])

    if loop_closures and S >= 3:
        closure_pairs = [(0, S - 1)] + [(i, i + 2) for i in range(0, S - 2, 2)]
        for (i, j) in closure_pairs:
            if (i, j) in edges:
                continue
            # the chain-predicted relative pose T_i^-1 T_j as the init
            R0 = R_init[i].T @ R_init[j]
            t0 = R_init[i].T @ (t_init[j] - t_init[i])
            res = fine_align(j, i, R0=R0, t0=t0)
            if use_features and float(res.inlier_frac) < 0.5:
                res = feature_align(j, i, res)
            if float(res.inlier_frac) < 0.3:
                continue    # no overlap or a failed lock: reject the edge
            edges.append((i, j))
            Zr.append(res.R)
            Zt.append(res.t)

    ei = torch.tensor([e[0] for e in edges], device=dev)
    ej = torch.tensor([e[1] for e in edges], device=dev)
    pg = pose_graph_optimize(torch.stack(R_init), torch.stack(t_init), ei, ej,
                             torch.stack(Zr), torch.stack(Zt),
                             iters=cfg.pg_iters, damping=cfg.pg_damping)
    return RegisteredScans(R=pg.R, t=pg.t, icp_rms=torch.stack(rms_list),
                           pg_rms=pg.rms)
