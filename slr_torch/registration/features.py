"""Coarse registration: FPFH descriptors and batched RANSAC (port of
``slr/registration/features.py``).

- descriptor: two-pass FPFH, histograms of the Darboux-frame angles
  (alpha, phi, theta) over the k nearest neighbours, 11 bins each (33-d);
- matching: mutual nearest descriptors from one similarity matmul;
- RANSAC: every hypothesis at once: draw 3 matches each, the rigid
  length-consistency test, a batched Kabsch fit (``torch.linalg.svd`` on
  (n_iters, 3, 3)), inlier counts, argmax; then two IRLS refits.
"""

from __future__ import annotations

import math

import torch

from slr_torch import observability as obs


def _knn(query, target, k: int, tile: int = 2048):
    """k nearest neighbours by tiled distance blocks and a running top-k
    merge. Returns (idx (Q,k) int64, d2 (Q,k)); a stable sort keeps the
    lower index first among equal distances, as ``lax.top_k`` does."""
    Q, T = query.shape[0], target.shape[0]
    dev = query.device
    tile = min(tile, T)
    q2 = torch.sum(query * query, dim=1)
    best_d = torch.full((Q, k), float("inf"), device=dev)
    best_i = torch.zeros((Q, k), dtype=torch.int64, device=dev)
    for base in range(0, T, tile):
        t_blk = target[base:base + tile]
        t2 = torch.sum(t_blk * t_blk, dim=1)
        d2 = q2[:, None] + t2[None, :] - 2.0 * (query @ t_blk.T)
        idx = torch.arange(base, base + t_blk.shape[0], device=dev)
        d_all = torch.cat([best_d, d2], dim=1)
        i_all = torch.cat([best_i, idx.expand(Q, -1)], dim=1)
        best_d, sel = torch.sort(d_all, dim=1, stable=True)
        best_d, sel = best_d[:, :k], sel[:, :k]
        best_i = torch.gather(i_all, 1, sel)
    return best_i, best_d


def _spfh(points, normals, idx, bins: int):
    """Simple point-feature histogram per point over its knn (N, 3*bins)."""
    nb_p = points[idx]                     # (N,k,3)
    nb_n = normals[idx]
    d = nb_p - points[:, None, :]
    dist = torch.linalg.norm(d, dim=-1, keepdim=True)
    self_nb = dist[..., 0] < 1e-9          # the knn of a point includes itself
    d_unit = d / torch.where(dist < 1e-9, 1.0, dist)
    # Darboux frame u = n, v = d x u, w = u x v
    u = normals[:, None, :].expand(nb_p.shape)
    v = torch.cross(d_unit, u, dim=-1)
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    v = v / torch.where(vn < 1e-9, 1.0, vn)
    w = torch.cross(u, v, dim=-1)
    alpha = torch.sum(v * nb_n, dim=-1)                     # [-1,1]
    phi = torch.sum(u * d_unit, dim=-1)                     # [-1,1]
    theta = torch.atan2(torch.sum(w * nb_n, dim=-1), torch.sum(u * nb_n, dim=-1))
    valid = (~self_nb).to(torch.float32)                    # drop the self pair

    def hist(x, lo, hi):
        xb = torch.clamp((x - lo) / (hi - lo) * bins, 0, bins - 1e-3)
        oh = torch.nn.functional.one_hot(torch.floor(xb).to(torch.int64), bins)
        return torch.sum(oh.to(torch.float32) * valid[..., None], dim=1)

    return torch.cat([hist(alpha, -1.0, 1.0), hist(phi, -1.0, 1.0),
                      hist(theta, -math.pi, math.pi)], dim=1)


def fpfh_features(points, normals, k: int = 16, bins: int = 11):
    """FPFH descriptors (N, 3*bins), L2-normalised: the SPFH of each point
    plus the inverse-distance-weighted mean SPFH of its neighbours (Rusu et
    al.'s two passes)."""
    idx, d2 = _knn(points, points, k=k)
    s = _spfh(points, normals, idx, bins)
    # distance-weighted neighbour aggregation; self (d2 ~ 0) excluded
    wd = torch.where(d2 > 1e-9, 1.0 / torch.sqrt(torch.clamp(d2, min=1e-9)), 0.0)
    f = s + torch.sum(s[idx] * wd[..., None], dim=1) / (
        torch.sum(wd, dim=1, keepdim=True) + 1e-9)
    return f / (torch.linalg.norm(f, dim=1, keepdim=True) + 1e-9)


def _kabsch(P, Q, w):
    """Weighted rigid fits Q ~ R P + t (Kabsch, no scale), batched over the
    leading dims: P, Q (..., n, 3), w (..., n) -> R (..., 3, 3), t (..., 3)."""
    ws = torch.sum(w, dim=-1, keepdim=True) + 1e-9
    cp = torch.sum(P * w[..., None], dim=-2) / ws
    cq = torch.sum(Q * w[..., None], dim=-2) / ws
    P0, Q0 = P - cp[..., None, :], Q - cq[..., None, :]
    H = (P0 * w[..., None]).transpose(-1, -2) @ Q0
    # its checks read the card twice: torch 2.11's, counted on an H100 by
    # torch.cuda.set_sync_debug_mode; another torch may read another number
    with obs.wait("kabsch.svd", syncs=2):
        U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    # D = diag(1, 1, sign), built without an in-place write: batched
    # registration runs this under torch.func.vmap
    sign = torch.sign(torch.linalg.det(V @ Ut))[..., None]
    D = torch.cat([torch.ones_like(sign), torch.ones_like(sign), sign], dim=-1)
    R = V @ (D[..., None] * Ut)
    return R, cq - torch.einsum("...ij,...j->...i", R, cp)


def draw_categorical(p, n: int, generator=None):
    """``n`` indices drawn with replacement with probabilities proportional
    to ``p`` (1-D, non-negative), the same bits in every call with the same
    generator state, on every device.

    ``torch.multinomial`` is not reproducible on the card: it scans a float
    cumulative distribution with a reduction order that changes between
    calls, and a rounding that moves a bin edge moves a sample. Here the
    weights are fixed-point integers (``p / max(p)`` in units of 2^-b, with b
    chosen so that their sum stays below 2^62), whose cumulative sum is
    exact in any order; each sample is the first index whose cumulative
    weight exceeds ``floor(u * total)``, u uniform in [0, 1) in float64.
    A weight below 2^-b of the largest rounds to 0 and is never drawn."""
    m = p.numel()
    bits = 62 - max(m - 1, 1).bit_length()
    w = p.to(torch.float64)
    w = torch.round(w / torch.max(w) * float(2 ** bits)).to(torch.int64)
    cum = torch.cumsum(w, 0)
    total = cum[-1:]
    u = torch.rand(n, generator=generator, dtype=torch.float64, device=p.device)
    target = torch.minimum(torch.floor(u * total.to(torch.float64)).to(torch.int64),
                           total - 1)
    return torch.searchsorted(cum, target, right=True)


def _draw_hypotheses(probs, n_iters: int, generator=None):
    """(n_iters, 3) match indices, drawn with replacement with ``probs``
    (the counterpart of the reference's ``jax.random.choice(..., p=probs)``
    per hypothesis; a test may substitute the JAX draw)."""
    return draw_categorical(probs, 3 * n_iters, generator).reshape(n_iters, 3)


def _ransac_matches(src_feat, tgt_feat):
    """Mutual nearest descriptors weighted by the ratio-test margin: (fwd
    (N,) target index of each source point, mutual (N,) bool, match_w (N,),
    probs (N,): the hypotheses' draw probabilities)."""
    sim = src_feat @ tgt_feat.T                        # cosine (unit features)
    top2, top2_i = torch.topk(sim, 2, dim=1)
    fwd = top2_i[:, 0]
    bwd = torch.argmax(sim, dim=0)
    mutual = bwd[fwd] == torch.arange(src_feat.shape[0], device=src_feat.device)
    margin = torch.clamp(top2[:, 0] - top2[:, 1], min=0.0)
    match_w = mutual.to(torch.float32) * margin
    probs = match_w + 1e-5
    return fwd, mutual, match_w, probs / torch.sum(probs)


def _edges(X):
    """The 3 pairwise edges of each sample of 3 points, X (n, 3, 3); each
    list of indices is a copy to the card that the host waits for (two
    syncs: torch 2.11's, counted on an H100 by set_sync_debug_mode)."""
    with obs.wait("ransac.edges", syncs=2):
        return X[:, [0, 0, 1]] - X[:, [1, 2, 2]]


def _ransac_fit(P, Q, mutual, match_w, sel, inlier_dist: float):
    """Score the hypotheses ``sel`` (n_iters, 3) on the matched pairs P -> Q
    and refit the winner twice on its inliers: (R, t, inlier_frac)."""
    d2_thresh = inlier_dist * inlier_dist
    Ps, Qs = P[sel], Q[sel]                            # (n_iters, 3, 3)
    # rigid length-consistency test on the 3 pairwise edges
    dp = torch.linalg.norm(_edges(Ps), dim=-1)
    dq = torch.linalg.norm(_edges(Qs), dim=-1)
    tol = torch.clamp(0.1 * torch.maximum(dp, dq), min=inlier_dist)
    consistent = torch.all(torch.abs(dp - dq) < tol, dim=1)
    # near-collinear samples fit any rotation: reject
    area2 = torch.linalg.norm(torch.cross(Ps[:, 1] - Ps[:, 0], Ps[:, 2] - Ps[:, 0],
                                          dim=-1), dim=-1)
    good = consistent & (area2 > 1e-3)
    Rs, ts = _kabsch(Ps, Qs, torch.ones(sel.shape, device=P.device))
    moved = torch.einsum("hij,nj->hni", Rs, P) + ts[:, None, :]
    inliers = (torch.sum((moved - Q) ** 2, dim=-1) < d2_thresh) & mutual
    counts = torch.where(good, torch.sum(inliers, dim=1), -1)
    best = torch.argmax(counts).reshape(1)
    R, t = Rs.index_select(0, best)[0], ts.index_select(0, best)[0]
    # IRLS refit on the winner's inliers
    w = match_w
    for _ in range(2):
        moved = P @ R.T + t
        w = ((torch.sum((moved - Q) ** 2, dim=1) < d2_thresh) & mutual).to(torch.float32)
        R, t = _kabsch(P, Q, w + 1e-9 * match_w)
    return R, t, torch.sum(w) / (torch.sum(mutual) + 1e-9)


def ransac_align(src_pts, src_feat, tgt_pts, tgt_feat, n_iters: int = 256,
                 inlier_dist: float = 5.0, generator=None):
    """Feature-matched RANSAC rigid alignment src -> tgt: (R, t, inlier_frac).

    Matches are mutual nearest descriptors weighted by the ratio-test
    margin; each hypothesis's 3 draws must pass the rigid length-consistency
    test and span a triangle before its Kabsch fit counts; the winner by
    inlier count is refit twice on its inliers. ``generator``: the
    ``torch.Generator`` of the draw (default: one seeded 0 on the device).
    """
    if generator is None:
        generator = torch.Generator(device=src_pts.device).manual_seed(0)
    fwd, mutual, match_w, probs = _ransac_matches(src_feat, tgt_feat)
    sel = _draw_hypotheses(probs, n_iters, generator)
    return _ransac_fit(src_pts, tgt_pts[fwd], mutual, match_w, sel, inlier_dist)
