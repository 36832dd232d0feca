"""Chessboard corner detection, sub-pixel refinement and grid ordering
(port of ``slr/calib/corners.py``).

The dense work (Gaussian smoothing, the Hessian saddle response, non-max
suppression, the windowed gradient-orthogonality refinement) runs in torch
over the whole image and all corners at once; the ordering of ~54 detected
points into a cols x rows grid runs on the device first (an extreme quad,
the 8 hull -> grid assignments as one batch of exact 4-point homographies,
nearest-neighbour matching and a weighted-DLT refit) and takes the host
path (numpy, scipy's ``ConvexHull``) only where the device path reports
``ok=False``: the reference's own algorithm, not a fall-back from the
device. ``detect_chessboard.device_views`` and ``.host_views`` count the
views each path ordered.

Corner model: chessboard X-junctions are saddle points of the smoothed
intensity, so the detector peaks ``Ixy^2 - Ixx*Iyy``, which is edge-free by
construction. Sub-pixel model (the normal equations cv2.cornerSubPix
solves): around a saddle q every gradient g(p) is orthogonal to (p - q), so
q solves ``(sum w g g^T) q = sum w g g^T p`` over a window; iterate.

Where the port is deliberately exact about order:
- the k best candidates are taken by a stable descending sort, so equal
  scores (every suppressed pixel is 0) come lowest index first, as
  ``jax.lax.top_k`` gives them (``torch.topk`` orders ties arbitrarily on
  the card);
- the Gaussian is a sum of shifted copies in a fixed order (no
  convolution library), so two calls give the same bits on any device;
- windows are gathered at the reference's clipped starts.

Assumes the full board is visible in the image (cv2 requires the same).
"""

from __future__ import annotations

import math
from itertools import combinations

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------- dense part

def _gauss_taps(sigma: float, device):
    r = int(np.ceil(3.0 * sigma))
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k), r


def _shifted_sum(img, k, r: int, dim: int):
    """Correlate ``img`` with taps ``k`` along ``dim`` (-1 or -2), zero
    borders ('same' size): sum_i k[i] * img shifted by i - r, in order."""
    n = img.shape[dim]
    pad = (r, r) if dim == -1 else (0, 0, r, r)
    p = F.pad(img, pad)
    out = k[0] * p.narrow(dim, 0, n)
    for i in range(1, 2 * r + 1):
        out = out + k[i] * p.narrow(dim, i, n)
    return out


def gaussian_blur(img, sigma: float):
    """Separable Gaussian of (..., H, W) images, zero borders, 'same' size:
    rows, then columns (also the renderer's projector defocus)."""
    k, r = _gauss_taps(sigma, img.device)
    return _shifted_sum(_shifted_sum(img, k, r, -1), k, r, -2)


def _edge_pad(g):
    return F.pad(g[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]


def chess_corner_response(img, sigma: float = 2.0):
    """Saddle-point response Ixy^2 - Ixx*Iyy of the smoothed image."""
    g = gaussian_blur(img, sigma)
    pad = _edge_pad(g)
    Ixx = pad[1:-1, 2:] - 2.0 * g + pad[1:-1, :-2]
    Iyy = pad[2:, 1:-1] - 2.0 * g + pad[:-2, 1:-1]
    Ixy = 0.25 * (pad[2:, 2:] - pad[2:, :-2] - pad[:-2, 2:] + pad[:-2, :-2])
    return torch.clamp(Ixy * Ixy - Ixx * Iyy, min=0.0)


def corner_candidates(img, k: int, nms_radius: int = 5, sigma: float = 2.0):
    """Top-k saddle peaks after non-max suppression.

    Returns (xy (k,2) float32, score (k,)); low-score rows are filler
    (score 0) for images with fewer true corners than k. Equal scores come
    lowest flat index first."""
    img = img.to(torch.float32)
    resp = chess_corner_response(img, sigma)
    w = 2 * nms_radius + 1
    m = F.max_pool2d(resp[None, None], w, stride=1, padding=nms_radius)[0, 0]
    peaks = torch.where((resp == m) & (resp > 0.05 * torch.max(resp)), resp, 0.0)
    score, idx = torch.sort(peaks.reshape(-1), descending=True, stable=True)
    score, idx = score[:k], idx[:k]
    W = img.shape[1]
    xy = torch.stack([(idx % W).to(torch.float32), (idx // W).to(torch.float32)], dim=-1)
    return xy, score


def _windows(maps, cy, cx, r: int):
    """The (2r+1)^2 windows of each (H, W) map in ``maps`` whose top-left
    corners are (cy - r, cx - r), (N,) int64 each: a list of (N, 2r+1,
    2r+1)."""
    off = torch.arange(-r, r + 1, device=cy.device)
    rows = (cy[:, None] + off)[:, :, None]
    cols = (cx[:, None] + off)[:, None, :]
    return [m[rows, cols] for m in maps]


def _clipped_centre(c, r: int, n: int):
    """round(c) clipped into [r, n - r - 1], as an int64 index: the window
    of radius r around it lies inside the image (the reference's clipped
    ``dynamic_slice`` start plus r)."""
    return torch.clamp(torch.round(c).to(torch.int64), r, n - r - 1)


def refine_subpix(img, pts, win: int = 5, iters: int = 4, sigma: float = 1.0):
    """Gradient-orthogonality sub-pixel refinement of corner estimates.

    pts (N,2) in (x, y); the window is (2*win+1)^2 with Gaussian weights;
    ``iters`` re-centred solves, every corner at once."""
    g = gaussian_blur(img.to(torch.float32), sigma)
    pad = _edge_pad(g)
    gx = 0.5 * (pad[1:-1, 2:] - pad[1:-1, :-2])
    gy = 0.5 * (pad[2:, 1:-1] - pad[:-2, 1:-1])
    H, W = img.shape
    off = torch.arange(-win, win + 1, dtype=torch.float32, device=img.device)
    oy, ox = off[:, None], off[None, :]
    wgt = torch.exp(-(ox ** 2 + oy ** 2) / (2.0 * (0.6 * win) ** 2))
    q = pts.to(torch.float32)

    def wsum(a):
        return torch.sum(wgt * a, dim=(-2, -1))

    for _ in range(iters):
        cx = _clipped_centre(q[:, 0], win, W)
        cy = _clipped_centre(q[:, 1], win, H)
        px, py = _windows((gx, gy), cy, cx, win)
        Xc = cx.to(torch.float32)[:, None, None] + ox
        Yc = cy.to(torch.float32)[:, None, None] + oy
        a = wsum(px * px)
        b = wsum(px * py)
        c = wsum(py * py)
        bx = wsum(px * px * Xc + px * py * Yc)
        by = wsum(px * py * Xc + py * py * Yc)
        det = a * c - b * b
        det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
        q_new = torch.stack([(c * bx - b * by) / det, (a * by - b * bx) / det], dim=-1)
        # clamp the step: a bad window cannot fling the corner away
        q = torch.minimum(torch.maximum(q_new, q - win), q + win)
    return q


# ------------------------------------------------------ device-side ordering

def _h_apply(H, p):
    """Homographies H (..., 3, 3) applied to points p (..., M, 2)."""
    H = H[..., None, :, :]
    w = H[..., 2, 0] * p[..., 0] + H[..., 2, 1] * p[..., 1] + H[..., 2, 2]
    w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    x = (H[..., 0, 0] * p[..., 0] + H[..., 0, 1] * p[..., 1] + H[..., 0, 2]) / w
    y = (H[..., 1, 0] * p[..., 0] + H[..., 1, 1] * p[..., 1] + H[..., 1, 2]) / w
    return torch.stack([x, y], dim=-1)


def _h_from_quad(src, dst):
    """Exact homographies src (4,2) -> dst (..., 4, 2) by the 8x8 linear
    system with h22 = 1 (the board plane never passes through the camera
    centre, so h22 stays away from 0)."""
    src = src.expand(*dst.shape[:-2], 4, 2)
    sx, sy = src[..., 0], src[..., 1]
    dx, dy = dst[..., 0], dst[..., 1]
    one, zero = torch.ones_like(sx), torch.zeros_like(sx)
    r1 = torch.stack([sx, sy, one, zero, zero, zero, -dx * sx, -dx * sy], dim=-1)
    r2 = torch.stack([zero, zero, zero, sx, sy, one, -dy * sx, -dy * sy], dim=-1)
    A = torch.stack([r1, r2], dim=-2).reshape(*dst.shape[:-2], 8, 8)
    b = torch.stack([dx, dy], dim=-1).reshape(*dst.shape[:-2], 8)
    eye = torch.eye(8, device=dst.device)
    h, _ = torch.linalg.solve_ex(A + 1e-9 * eye, b)
    return torch.cat([h, torch.ones_like(h[..., :1])], dim=-1).reshape(*h.shape[:-1], 3, 3)


def _h_dlt(src, dst):
    """Least-squares homography src (N,2) -> dst (N,2): normalized DLT,
    the right singular vector of the smallest singular value."""
    def normalize(p):
        c = p.mean(dim=0)
        s = math.sqrt(2.0) / torch.clamp(torch.linalg.norm(p - c, dim=1).mean(), min=1e-9)
        z, o = torch.zeros_like(s), torch.ones_like(s)
        T = torch.stack([torch.stack([s, z, -s * c[0]]), torch.stack([z, s, -s * c[1]]),
                         torch.stack([z, z, o])])
        return (p - c) * s, T

    sn, Ts = normalize(src)
    dn, Td = normalize(dst)
    one, zero = torch.ones_like(sn[:, :1]), torch.zeros_like(sn)
    r1 = torch.cat([sn, one, zero, torch.zeros_like(one), -dn[:, 0:1] * sn, -dn[:, 0:1]], 1)
    r2 = torch.cat([zero, torch.zeros_like(one), sn, one, -dn[:, 1:2] * sn, -dn[:, 1:2]], 1)
    A = torch.stack([r1, r2], dim=1).reshape(-1, 9)
    _, _, Vh = torch.linalg.svd(A, full_matrices=False)
    H = torch.linalg.inv(Td) @ Vh[-1].reshape(3, 3) @ Ts
    return H / H[2, 2]


def _extreme_quad(pts, valid):
    """Convex quad of extreme detections in cyclic order: p0/p1 the farthest
    valid pair from the centroid's farthest point, p2/p3 the extreme points
    on either side of the p0-p1 line. For a perspective-projected rectangle
    these are the four board corners."""
    big = 1e12
    pen = torch.where(valid, 0.0, -big)
    vf = valid.to(torch.float32)
    c = torch.sum(pts * vf[:, None], dim=0) / torch.clamp(vf.sum(), min=1.0)
    p0 = pts[torch.argmax(torch.linalg.norm(pts - c, dim=1) + pen)]
    p1 = pts[torch.argmax(torch.linalg.norm(pts - p0, dim=1) + pen)]
    e = p1 - p0
    cross = (pts[:, 0] - p0[0]) * e[1] - (pts[:, 1] - p0[1]) * e[0]
    p2 = pts[torch.argmax(torch.where(valid, cross, -big))]
    p3 = pts[torch.argmax(torch.where(valid, -cross, -big))]
    return torch.stack([p0, p2, p1, p3])


def _grid(cols: int, rows: int, device):
    jj, ii = torch.meshgrid(torch.arange(cols, dtype=torch.float32, device=device),
                            torch.arange(rows, dtype=torch.float32, device=device),
                            indexing="xy")
    return torch.stack([jj.reshape(-1), ii.reshape(-1)], dim=-1)     # (N,2) row-major


def _match(pred, pts, valid):
    """Nearest valid detection of each predicted node: (index, distance),
    ties lowest index first."""
    d = torch.linalg.norm(pred[..., :, None, :] - pts, dim=-1)
    d = torch.where(valid, d, float("inf"))
    nn = torch.argmin(d, dim=-1)
    return nn, torch.take_along_dim(d, nn[..., None], dim=-1)[..., 0]


def _distinct(nn, K: int):
    """Whether the matches of each assignment hit distinct detections."""
    hit = F.one_hot(nn, K).sum(dim=-2) > 0
    return hit.sum(dim=-1) == nn.shape[-1]


def order_corner_grid_device(pts, valid, cols: int, rows: int):
    """Device-side grid ordering: extreme-quad selection, the 8 hull -> grid
    assignments as a batch of exact 4-point homographies (filtered by the
    sign of their Jacobian: a mirror assignment flips the board's
    handedness), nearest-neighbour matching, then a DLT refit on all
    matches and a rematch.

    pts (K, 2) with ``valid`` masking filler rows. Returns (ordered
    (cols*rows, 2), rms, ok): ok False when no orientation-preserving
    assignment matches every node to a distinct detection."""
    pts = pts.to(torch.float32)
    K, N, dev = pts.shape[0], cols * rows, pts.device
    ideal = torch.tensor([[0, 0], [cols - 1, 0], [cols - 1, rows - 1], [0, rows - 1]],
                         dtype=torch.float32, device=dev)
    grid = _grid(cols, rows, dev)
    quad = _extreme_quad(pts, valid)
    # assignment a: flip = a // 4 (reverse the quad), then roll by a % 4
    order = torch.tensor([[(i - s) % 4 if f == 0 else 3 - (i - s) % 4 for i in range(4)]
                          for f in range(2) for s in range(4)], device=dev)
    Hs = _h_from_quad(ideal, quad[order])                           # (8,3,3)
    centre = torch.tensor([(cols - 1) / 2.0, (rows - 1) / 2.0], device=dev)
    eps = 0.1
    probes = centre + torch.tensor([[eps, 0.0], [-eps, 0.0], [0.0, eps], [0.0, -eps]],
                                   device=dev)
    pr = _h_apply(Hs, probes)                                       # (8,4,2)
    dx, dy = pr[:, 0] - pr[:, 1], pr[:, 2] - pr[:, 3]
    jac = dx[:, 0] * dy[:, 1] - dx[:, 1] * dy[:, 0]
    nn_all, dist = _match(_h_apply(Hs, grid), pts, valid)          # (8,N)
    res = (dist.mean(dim=-1) + torch.where(_distinct(nn_all, K), 0.0, 1e6)
           + torch.where(jac > 0, 0.0, 1e9))
    best = torch.argmin(res)
    ok = res[best] < 1e6
    # refit on all matches for a tighter prediction, then rematch
    H = _h_dlt(grid, pts[nn_all[best]])
    nn, dist = _match(_h_apply(H, grid), pts, valid)
    ok = ok & _distinct(nn, K)
    return pts[nn], torch.sqrt(torch.mean(dist ** 2)), ok


def _fix_checker_orientation_device(img, ordered, cols: int, rows: int):
    """The 180-degree tie-break on the device: board cell (0, 0) is LIGHT."""
    H = _h_dlt(_grid(cols, rows, ordered.device), ordered)
    probe = _h_apply(H, torch.tensor([[0.5, 0.5], [cols - 1.5, rows - 1.5]],
                                     device=ordered.device))
    h, w = img.shape
    xy = torch.round(probe).to(torch.int64)
    x, y = xy[:, 0].clamp(0, w - 1), xy[:, 1].clamp(0, h - 1)
    i = img[y, x]
    return torch.where(i[0] < i[1], ordered.flip(0), ordered)


# ------------------------------------------------------------ host ordering

def _dlt_homography(src, dst):
    """Least-squares homography src -> dst (numpy, normalized DLT)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)

    def normalize(p):
        c = p.mean(0)
        s = np.sqrt(2.0) / max(np.linalg.norm(p - c, axis=1).mean(), 1e-9)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])
        return (p - c) * s, T

    sn, Ts = normalize(src)
    dn, Td = normalize(dst)
    n = len(src)
    A = np.zeros((2 * n, 9))
    A[0::2, 0:2] = sn
    A[0::2, 2] = 1
    A[0::2, 6:8] = -dn[:, 0:1] * sn
    A[0::2, 8] = -dn[:, 0]
    A[1::2, 3:5] = sn
    A[1::2, 5] = 1
    A[1::2, 6:8] = -dn[:, 1:2] * sn
    A[1::2, 8] = -dn[:, 1]
    _, _, vt = np.linalg.svd(A)
    H = np.linalg.inv(Td) @ vt[-1].reshape(3, 3) @ Ts
    return H / H[2, 2]


def _apply_h(H, p):
    q = np.c_[p, np.ones(len(p))] @ H.T
    return q[:, :2] / q[:, 2:3]


def _hull_quad(pts):
    """4 extreme points of the detected cloud, in convex (cyclic) order."""
    from scipy.spatial import ConvexHull

    hv = ConvexHull(pts).vertices  # ccw
    if len(hv) == 4:
        return hv
    best, best_area = None, -1.0
    for comb in combinations(range(len(hv)), 4):
        q = pts[hv[list(comb)]]
        # shoelace area of the cyclic quad (hull order preserved)
        x, y = q[:, 0], q[:, 1]
        area = 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
        if area > best_area:
            best_area, best = area, hv[list(comb)]
    return np.asarray(best)


def order_corner_grid(pts, cols: int, rows: int):
    """Order detected corner candidates into the cols x rows grid (host).

    pts (K,2) numpy, K >= cols*rows (extra spurious candidates allowed).
    Tries the 8 assignments of the detected hull quad to the ideal grid quad
    (4 cyclic shifts x 2 orientations), keeps the homography whose grid
    prediction matches the detections best, then refits on all matches.
    Returns (ordered (cols*rows, 2) float32, rms residual in px)."""
    pts = np.asarray(pts, np.float64)
    quad = pts[_hull_quad(pts)]
    ideal_quad = np.array([[0, 0], [cols - 1, 0], [cols - 1, rows - 1], [0, rows - 1]],
                          np.float64)
    jj, ii = np.meshgrid(np.arange(cols), np.arange(rows))
    grid = np.c_[jj.ravel(), ii.ravel()].astype(np.float64)

    def match(H):
        d = np.linalg.norm(_apply_h(H, grid)[:, None] - pts[None], axis=-1)
        nn = d.argmin(1)
        return nn, d[np.arange(len(grid)), nn]

    centre = np.array([[(cols - 1) / 2.0, (rows - 1) / 2.0]])
    eps = 0.1

    def jac_det(H):
        dx = _apply_h(H, centre + [eps, 0]) - _apply_h(H, centre - [eps, 0])
        dy = _apply_h(H, centre + [0, eps]) - _apply_h(H, centre - [0, eps])
        return dx[0, 0] * dy[0, 1] - dx[0, 1] * dy[0, 0]

    best = None
    for flip in (1, -1):
        for shift in range(4):
            H = _dlt_homography(ideal_quad, np.roll(quad[::flip], shift, axis=0))
            # a mirror assignment fits as well as the true one but flips the
            # plane's handedness; a really-projected board face never does
            if jac_det(H) <= 0:
                continue
            nn, dist = match(H)
            res = np.mean(dist)
            # a valid assignment matches each grid node to a distinct point
            if len(np.unique(nn)) != len(grid):
                res += 1e6
            if best is None or res < best[0]:
                best = (res, nn)
    if best is None:
        raise ValueError("chessboard grid ordering failed: no orientation-"
                         "preserving hull assignment")
    # refit on all matches for a tighter prediction, then rematch
    nn, dist = match(_dlt_homography(grid, pts[best[1]]))
    if len(np.unique(nn)) != len(grid):
        raise ValueError("chessboard grid ordering failed: ambiguous match")
    return pts[nn].astype(np.float32), float(np.sqrt((dist ** 2).mean()))


def _fix_checker_orientation(img_np, ordered, cols: int, rows: int):
    """Resolve the 180-degree grid ambiguity with the checker colours
    (host): board cell (0, 0), on the (+x, +y) side of corner (0, 0), is
    LIGHT (``slr_torch.synth.board``'s convention, and cv2's trick)."""
    jj, ii = np.meshgrid(np.arange(cols), np.arange(rows))
    H = _dlt_homography(np.c_[jj.ravel(), ii.ravel()], ordered)
    probe = _apply_h(H, np.array([[0.5, 0.5], [cols - 1.5, rows - 1.5]], np.float64))
    h, w = img_np.shape
    xy = np.clip(np.round(probe).astype(int), 0, [w - 1, h - 1])
    if img_np[xy[0, 1], xy[0, 0]] < img_np[xy[1, 1], xy[1, 0]]:
        return ordered[::-1]
    return ordered


def detect_chessboard(img, cols: int, rows: int, extra: int = 12,
                      sigma: float = 2.0, win: int = 5):
    """Saddle peaks -> grid ordering -> sub-pixel refinement.

    Returns (corners (cols*rows, 2) float32 on ``img``'s device, in cv2's
    ordering (row-major, x first), grid-fit rms). The device ordering
    first; the host ordering (over three candidate subsets) only where it
    reports ok=False or a grid rms >= 3 px. Raises ValueError if no
    coherent grid is found."""
    img = torch.as_tensor(img).to(torch.float32)
    K = cols * rows
    cand, score = corner_candidates(img, K + extra, sigma=sigma)
    # scores come sorted, so the K-th strongest is score[K - 1]
    valid_d = (score > 0) & (score >= 0.5 * score[K - 1])
    ordered_d, rms_d, ok_d = order_corner_grid_device(cand, valid_d, cols, rows)
    if bool(ok_d) and float(rms_d) < 3.0:
        ordered_d = _fix_checker_orientation_device(img, ordered_d, cols, rows)
        detect_chessboard.device_views += 1
        return refine_subpix(img, ordered_d, win=win), float(rms_d)

    detect_chessboard.host_views += 1
    cand_np = cand.cpu().numpy()
    score_np = score.cpu().numpy()
    live = score_np > 0
    if live.sum() < K:
        raise ValueError(f"found only {int(live.sum())} corner candidates, need {K}")
    # X-junction saddles score several times higher than the T-junction
    # saddles at the squares/margin boundary; filtering relative to the
    # K-th strongest keeps the hull quad on the true corner grid; looser
    # candidate sets follow if the strict one fails
    kth = np.sort(score_np[live])[::-1][K - 1]
    subsets = [cand_np[live & (score_np >= 0.5 * kth)],
               cand_np[np.argsort(score_np)[::-1][:K]],
               cand_np[live]]
    err = None
    for sub in subsets:
        if len(sub) < K:
            continue
        try:
            ordered, grid_rms = order_corner_grid(sub, cols, rows)
        except ValueError as e:
            err = e
            continue
        ordered = _fix_checker_orientation(img.cpu().numpy(), ordered, cols, rows)
        ordered = torch.as_tensor(np.ascontiguousarray(ordered), device=img.device)
        return refine_subpix(img, ordered, win=win), grid_rms
    raise err if err is not None else ValueError("grid ordering failed")


detect_chessboard.device_views = 0
detect_chessboard.host_views = 0
