"""Multi-scan registration and fusion (configs 4-5; port of
``slr/pipeline/registerfuse.py``).

``register_scans``: sequential pairwise alignment (point-to-plane ICP, raced
against an FPFH + RANSAC-initialised ICP, with a projective polish when the
rig camera is given) into a pose chain, loop-closure edges, then pose-graph
refinement over every relative measurement. ``register_scans_batched``: the
same with every edge of a round aligned at once: on the card in one launch
of each ICP route (``kernels/icp.py``), elsewhere along a leading edge axis
(``torch.func.vmap``, as the reference's ``jax.vmap``); the edges split
over the ``map_block`` ranks of a mesh. ``ba_refine``: Schur bundle adjustment
over landmarks drawn from every scan, distributed over a mesh's map blocks.
``fuse_scans``: every scan in the anchor frame, voxel-merged.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch
from torch.func import vmap

from slr_torch import observability as obs
from slr_torch.config import RegistrationConfig
from slr_torch.dist import comm
from slr_torch.dist.ba import bundle_adjust_reference, distributed_bundle_adjust
from slr_torch.kernels import icp as icp_kernel
from slr_torch.pipeline.reconstruct import ScanCloud
from slr_torch.registration import features
from slr_torch.registration.features import draw_categorical, fpfh_features, ransac_align
from slr_torch.registration.icp import ICPResult, _resolve_nn_method, icp_point_to_plane
from slr_torch.registration.nn import nearest_neighbors
from slr_torch.registration.normals import grid_normals
from slr_torch.registration.posegraph import pose_graph_optimize
from slr_torch.registration.projective import icp_projective
from slr_torch.registration.voxel import voxel_downsample


class RegisteredScans(NamedTuple):
    R: torch.Tensor          # (S,3,3) scan -> anchor (world) rotations
    t: torch.Tensor          # (S,3)
    icp_rms: torch.Tensor    # (S-1,) pairwise ICP residuals
    pg_rms: torch.Tensor     # pose-graph residual RMS


def registered_scans_from_numpy(R, t, icp_rms, pg_rms, device="cpu") -> RegisteredScans:
    """Poses given as numpy arrays (the JAX ``RegisteredScans`` after
    ``jax.tree.map(np.asarray, reg)``) -> the port's ``RegisteredScans``."""
    return RegisteredScans(*(obs.upload("poses.upload", np.array(x, np.float32), device)
                             for x in (R, t, icp_rms, pg_rms)))


def _draw_samples(p, n: int, seed: int):
    """``n`` pixel indices drawn with replacement with probabilities ``p``
    (the counterpart of the reference's ``jax.random.choice(key, H*W, (n,),
    p=p)``; a test may substitute the JAX draw); the same bits in every
    call on every device."""
    return draw_categorical(p, n, torch.Generator(device=p.device).manual_seed(seed))


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


def _chain_init(Zr, Zt):
    """Chain odometry from the S-1 chain edges (s-1, s): pose s is pose s-1
    composed with the edge. Returns lists of S rotations and translations."""
    R_init = [torch.eye(3, device=Zr[0].device)]
    t_init = [torch.zeros(3, device=Zr[0].device)]
    for s in range(1, len(Zr) + 1):
        R_init.append(R_init[-1] @ Zr[s - 1])
        t_init.append(R_init[-2] @ Zt[s - 1] + t_init[-1])
    return R_init, t_init


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

    dev = clouds[0].points.device
    R_init, t_init = _chain_init(Zr, Zt)

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


def _batched_fine(src, tgt_p, tgt_n, cfg, R0=None, t0=None, grids=None, cam=None,
                  tgt_idx=None):
    """ICP over a batch of edges: src, tgt_p, tgt_n (E, N, 3), optional
    (E,) inits; then, with the stacked organized target grids and the (E,)
    index of each edge's target grid, the projective polish. On the card
    every edge goes at once into one launch of each route
    (``kernels/icp.py``): the NN route's wherever the exact search is
    taken (``takes_kernel``), the polish always. CPU tensors on the exact
    route go at once along the leading axis (``vmap``: batched products and
    Cholesky). The band search (K8) and the voxel hash take one cloud a
    call, so there the edges go one after another."""
    E, N = src.shape[:2]
    dev = src.device
    iters, dist = cfg.icp_iters, cfg.icp_max_corr_dist
    polish_iters = max(8, iters // 2)
    on_kernel = icp_kernel.takes_kernel(N, tgt_p.shape[1], dev)
    if R0 is None and not on_kernel:
        R0 = torch.eye(3, device=dev).expand(E, 3, 3)
        t0 = torch.zeros(E, 3, device=dev)

    def one(s, tp, tn, R_i, t_i):
        return icp_point_to_plane(s, tp, tn, R0=R_i, t0=t_i, iters=iters, max_corr_dist=dist)

    with obs.span("icp"):
        if on_kernel:
            res = ICPResult(*icp_kernel.align(src, tgt_p, tgt_n, R0=R0, t0=t0, iters=iters,
                                              max_corr_dist=dist))
        elif _resolve_nn_method("auto", N, tgt_p.shape[1], dev) == "exact":
            res = vmap(one)(src, tgt_p, tgt_n, R0, t0)
        else:
            res = ICPResult(*map(torch.stack, zip(*map(one, src, tgt_p, tgt_n, R0, t0))))
    if grids is not None:
        g_pts, g_mask, g_nrm = grids
        with obs.span("icp.polish"):
            if dev.type == "cuda":
                res = ICPResult(*icp_kernel.polish(src, None, g_pts, g_mask, g_nrm, tgt_idx, cam,
                                                   res.R, res.t, iters=polish_iters,
                                                   max_corr_dist=dist))
            else:
                ones = torch.ones(N, dtype=torch.bool, device=dev)

                def polish(s, tg, tm, tn, R_i, t_i):
                    return icp_projective(s, ones, tg, tm, tn, cam, R0=R_i, t0=t_i,
                                          iters=polish_iters, max_corr_dist=dist)

                res = vmap(polish)(src, g_pts[tgt_idx], g_mask[tgt_idx], g_nrm[tgt_idx],
                                   res.R, res.t)
    return res


def _batched_feature_race(src, src_n, tgt_p, tgt_n, res, cfg, race_mask, grids=None,
                          cam=None, tgt_idx=None):
    """FPFH + RANSAC inits and ICP for every edge at once, then a select on
    the device of whichever result locked better (the sequential race's
    rule), with no host read. ``race_mask`` (E,) bool: the edges whose
    result the race may replace.

    Each edge draws its hypotheses as a call of its own with a fresh
    generator seeded 0 would: the reference's vmapped RANSAC draws every
    edge with ``PRNGKey(0)``."""
    with obs.span("features.fpfh"):
        f_src = vmap(fpfh_features)(src, src_n)
        f_tgt = vmap(fpfh_features)(tgt_p, tgt_n)
    with obs.span("features.match"):
        fwd, mutual, match_w, probs = vmap(features._ransac_matches)(f_src, f_tgt)
    with obs.span("features.draws"):
        sel = torch.stack([features._draw_hypotheses(
            p, cfg.ransac_iters, torch.Generator(device=p.device).manual_seed(0))
            for p in probs])
    with obs.span("features.fit"):
        matched = torch.take_along_dim(tgt_p, fwd[..., None], dim=1)
        R0, t0, _ = vmap(features._ransac_fit, in_dims=(0, 0, 0, 0, 0, None))(
            src, matched, mutual, match_w, sel, cfg.ransac_inlier_dist)
    res_f = _batched_fine(src, tgt_p, tgt_n, cfg, R0=R0, t0=t0, grids=grids, cam=cam,
                          tgt_idx=tgt_idx)
    better = (res_f.inlier_frac > res.inlier_frac) | (
        (torch.abs(res_f.inlier_frac - res.inlier_frac) < 0.05) & (res_f.rms < res.rms))
    take = better & race_mask
    return ICPResult(R=torch.where(take[:, None, None], res_f.R, res.R),
                     t=torch.where(take[:, None], res_f.t, res.t),
                     rms=torch.where(take, res_f.rms, res.rms),
                     inlier_frac=torch.where(take, res_f.inlier_frac, res.inlier_frac))


def register_scans_batched(
    clouds: List[ScanCloud],
    cfg: RegistrationConfig = RegistrationConfig(),
    use_features: bool = True,
    cam=None,
    loop_closures: bool = True,
    mesh=None,
) -> RegisteredScans:
    """``register_scans`` with each round's pairwise alignments batched: the
    chain edges, given identity inits, in one round; the loop closures, from
    the chain-predicted inits, in another. The one host read is the closure
    accept/reject decision.

    A closure races the features only where its chain-init ICP did not lock
    (inlier fraction < 0.5), as the sequential path. The reference gets
    there in two passes, the first racing with an all-false mask, which
    keeps every result; the port takes the first pass without the race.

    With a ``mesh`` every rank passes every cloud; a round's edges, padded
    to a multiple of the map blocks, are split over ``map_block``, each rank
    aligns its block, and the round's results are gathered (the same bits
    on every rank) before any host decision.
    """
    with obs.span("register"):
        S = len(clouds)
        dev = clouds[0].points.device if S else torch.device("cpu")
        if S < 2:
            return RegisteredScans(R=torch.eye(3, device=dev).expand(S, 3, 3),
                                   t=torch.zeros(S, 3, device=dev),
                                   icp_rms=torch.zeros(0, device=dev),
                                   pg_rms=torch.zeros((), device=dev))
        with obs.span("register.samples"):
            samples = [_subsample(c, cfg.icp_sample_points, seed=i)
                       for i, c in enumerate(clouds)]
            pts = torch.stack([p for p, _ in samples])          # (S, N, 3)
            nrm = torch.stack([n for _, n in samples])
            grids = None
            if cam is not None:
                grids = (torch.stack([c.points for c in clouds]),
                         torch.stack([c.mask for c in clouds]),
                         torch.stack([grid_normals(c.points, c.mask) for c in clouds]))

        n_blocks = mesh.shape["map_block"] if mesh is not None else 1

        def run_edges(src_i, tgt_i, R0=None, t0=None, race_mask=None, res=None):
            """One round over the edges src_i -> tgt_i: ICP (unless ``res`` is
            given), then, with features, the race where ``race_mask``; with map
            blocks, this rank's block of the padded edges, then the gather."""
            with obs.span("register.round"):
                si = obs.upload("register.upload", src_i, dev)
                ti = obs.upload("register.upload", tgt_i, dev)
                E = len(src_i)
                if n_blocks > 1:
                    pad = (-E) % n_blocks
                    per, b = (E + pad) // n_blocks, mesh.coords["map_block"]

                    def block(x):
                        if x is None:
                            return None
                        if pad:
                            x = torch.cat([x, x[:1].expand((pad,) + tuple(x.shape[1:]))])
                        return x[b * per:(b + 1) * per]

                    si, ti, R0, t0, race_mask = map(block, (si, ti, R0, t0, race_mask))
                    res = None if res is None else ICPResult(*map(block, res))
                if res is None:
                    res = _batched_fine(pts[si], pts[ti], nrm[ti], cfg, R0=R0, t0=t0,
                                        grids=grids, cam=cam, tgt_idx=ti)
                if race_mask is not None:
                    res = _batched_feature_race(pts[si], nrm[si], pts[ti], nrm[ti], res, cfg,
                                                race_mask, grids=grids, cam=cam, tgt_idx=ti)
                if n_blocks > 1:
                    res = ICPResult(*(x[:E] for x in comm.all_gather_rows(
                        list(res), mesh.groups["map_block"])))
                return res

        # round 1: every chain edge (s-1, s), measurement T_{s-1}^-1 T_s
        race_all = torch.ones(S - 1, dtype=torch.bool, device=dev) if use_features else None
        chain = run_edges(list(range(1, S)), list(range(0, S - 1)), race_mask=race_all)
        edges = [(s - 1, s) for s in range(1, S)]
        R_init, t_init = _chain_init(chain.R, chain.t)
        Zr, Zt = list(chain.R), list(chain.t)

        # round 2: loop closures from the chain-predicted relative poses
        if loop_closures and S >= 3:
            pairs = [(0, S - 1)] + [(i, i + 2) for i in range(0, S - 2, 2)]
            pairs = [p for p in pairs if p not in edges]
            if pairs:
                src_i, tgt_i = [j for _, j in pairs], [i for i, _ in pairs]
                R0 = torch.stack([R_init[i].T @ R_init[j] for i, j in pairs])
                t0 = torch.stack([R_init[i].T @ (t_init[j] - t_init[i]) for i, j in pairs])
                res = run_edges(src_i, tgt_i, R0=R0, t0=t0)
                if use_features:
                    res = run_edges(src_i, tgt_i, race_mask=res.inlier_frac < 0.5, res=res)
                with obs.wait("register.accept"):
                    accept = (res.inlier_frac >= 0.3).tolist()
                for e, (i, j) in enumerate(pairs):
                    if accept[e]:
                        edges.append((i, j))
                        Zr.append(res.R[e])
                        Zt.append(res.t[e])

        with obs.span("pose_graph"):
            ei = obs.upload("register.upload", [e[0] for e in edges], dev)
            ej = obs.upload("register.upload", [e[1] for e in edges], dev)
            pg = pose_graph_optimize(torch.stack(R_init), torch.stack(t_init), ei, ej,
                                     torch.stack(Zr), torch.stack(Zt),
                                     iters=cfg.pg_iters, damping=cfg.pg_damping)
        return RegisteredScans(R=pg.R, t=pg.t, icp_rms=chain.rms, pg_rms=pg.rms)


def ba_refine(
    clouds: List[ScanCloud],
    reg: RegisteredScans,
    n_landmarks: int = 512,
    corr_dist: float = 3.0,
    iters: int = 8,
    mesh=None,
    rounds: int = 2,
    huber_delta: float = 1.0,
    point_to_plane: bool = True,
) -> RegisteredScans:
    """Multi-scan bundle adjustment on top of the pose-graph solution.

    Landmarks are an even draw from every scan's surface (4096 samples a
    scan, seed 100 + s), in the anchor frame at the current poses. A scan
    observes a landmark when its nearest sample (the exact search, in the
    scan's frame) lies within ``corr_dist``; poses and landmarks refine
    jointly by the Schur solver with Huber weights, in ``rounds`` rounds
    with the correspondences re-associated from the refined poses between
    them. ``pg_rms`` of the result is the BA rms. With a ``mesh`` the
    solve is ``distributed_bundle_adjust``, the landmarks split over
    ``map_block`` (``n_landmarks`` divisible by the blocks).
    """
    with obs.span("ba"):
        S = len(clouds)
        samples = [_subsample(c, 4096, seed=100 + i) for i, c in enumerate(clouds)]
        R_cur, t_cur = reg.R, reg.t
        per = [n_landmarks // S + (1 if i < n_landmarks % S else 0) for i in range(S)]
        X0 = torch.cat([samples[s][0][:per[s]] @ R_cur[s].T + t_cur[s] for s in range(S)])
        obs_s = torch.arange(S, device=X0.device).expand(n_landmarks, S)
        res = None
        for _ in range(max(1, rounds)):
            with obs.span("ba.associate"):
                obs_p, obs_n, obs_w = [], [], []
                for s, (pts_s, nrm_s) in enumerate(samples):
                    # the landmarks in scan s's frame: R_s^T (X - t_s)
                    idx, d2 = nearest_neighbors((X0 - t_cur[s]) @ R_cur[s], pts_s,
                                                tile=2048)
                    obs_w.append((d2 < corr_dist * corr_dist).to(torch.float32))
                    obs_p.append(pts_s[idx])
                    obs_n.append(nrm_s[idx])
                args = (R_cur, t_cur, X0, obs_s, torch.stack(obs_p, 1),
                        torch.stack(obs_w, 1))
                kw = dict(iters=max(1, iters // max(1, rounds)), huber_delta=huber_delta,
                          obs_n=torch.stack(obs_n, 1) if point_to_plane else None)
            with obs.span("ba.solve"):
                res = (bundle_adjust_reference(*args, **kw) if mesh is None
                       else distributed_bundle_adjust(*args, mesh, **kw))
            R_cur, t_cur, X0 = res.R, res.t, res.X
        return RegisteredScans(R=res.R, t=res.t, icp_rms=reg.icp_rms, pg_rms=res.rms)


def fuse_scans(
    clouds: List[ScanCloud],
    reg: RegisteredScans,
    cfg: RegistrationConfig = RegistrationConfig(),
    capacity: int = 1 << 20,
):
    """Every scan in the anchor frame, voxel-merged (voxel edge
    ``cfg.voxel_size``). Returns (points (capacity, 3), valid (capacity,),
    colors (capacity, 1), n_voxels)."""
    with obs.span("fuse"):
        pts = torch.cat([c.points.reshape(-1, 3) @ reg.R[s].T + reg.t[s]
                         for s, c in enumerate(clouds)])
        val = torch.cat([c.mask.reshape(-1) for c in clouds])
        col = torch.cat([c.colors.reshape(-1, 1) for c in clouds])
        return voxel_downsample(pts, val, cfg.voxel_size, capacity=capacity, attrs=col)
