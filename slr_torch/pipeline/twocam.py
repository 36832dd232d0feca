"""Two-camera structured-light reconstruction (port of
``slr/pipeline/twocam.py``).

Both cameras watch the scene and the projector only supplies per-pixel
correspondence codes: its calibration never enters the triangulation, so
projector distortion or drift cancels out. The pattern must code both
projector axes (``row_gray_bits > 0``), so each camera pixel decodes to a
full projector coordinate (x_p, y_p).

``reconstruct_two_camera`` has three rendezvous methods:

- "merge" (default): each camera's code maps are inverted onto the
  projector grid by two monotone-crossing passes (``invert_to_projector``:
  K7, or K6 through ``crossing_interp`` past the route rule), and every
  projector cell that both cameras found triangulates by the midpoint of
  their two rays. The cloud is organized on the (proj_h, proj_w) grid.
- "splat": cam 2's pixels splat moving-least-squares moments of their own
  image coordinates into a projector-resolution grid (one ``index_add_``),
  and each cam-1 pixel solves a local linear fit there. An oracle: its
  float atomics make it non-reproducible on the card.
- "search": a depth sweep plus bisection along each cam-1 ray for the
  depth at which cam 2's decoded column code matches. An oracle.

The two oracles give a cloud on the cam-1 grid, behind a left-right code
consistency gate.
"""

from __future__ import annotations

from typing import Tuple

import torch

from slr_torch import observability as obs
from slr_torch.codec.patterns import DecodeResult, decode_stack
from slr_torch.codec.unwrap import _shift_zero
from slr_torch.config import DecodeConfig, PatternConfig, ReconstructConfig
from slr_torch.geom.camera import Camera, pixel_to_ray, project
from slr_torch.geom.triangulate import _solve3x3, triangulate_midpoint
from slr_torch.kernels.crossing import crossing_interp, crossing_interp_fused, gate_mask
from slr_torch.kernels.fused_scan import fused_decode_triangulate
from slr_torch.pipeline.reconstruct import ScanCloud, _pixel_grid, _white_color

# moment-vector layout per projector cell (local coords d = X - cell):
# [ w, w dx, w dy, w dx2, w dxdy, w dy2,
#   w u, w u dx, w u dy, w v, w v dx, w v dy, w (u2+v2) ]
_NM = 13
# the reference's rule for the fused route (K7): the whole row in one block,
# and its TPU one-hot of (bins x pairs) under 8 MiB of VMEM
FUSED_MAX_WIDTH = 2560
FUSED_BUDGET = 8 * 2 ** 20

_CORNERS = ((0, 0), (1, 0), (0, 1), (1, 1))


def _corner_weights(fx, fy):
    return ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)


def _splat_moments(x_p, y_p, w, u, v, proj_w: int, proj_h: int):
    """Bilinearly scatter the MLS moment vector into a (proj_h, proj_w, 13)
    grid: one ``index_add_`` of a (4 H W, 13) payload."""
    x0, y0 = torch.floor(x_p), torch.floor(y_p)
    fx, fy = x_p - x0, y_p - y0
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    idxs, vals = [], []
    for (ddx, ddy), ww in zip(_CORNERS, _corner_weights(fx, fy)):
        xi = torch.clamp(x0 + ddx, 0, proj_w - 1)
        yi = torch.clamp(y0 + ddy, 0, proj_h - 1)
        wq = w * ww
        dx = x_p - xi.to(torch.float32)
        dy = y_p - yi.to(torch.float32)
        idxs.append((yi * proj_w + xi).reshape(-1))
        vals.append(torch.stack(
            [wq, wq * dx, wq * dy, wq * dx * dx, wq * dx * dy, wq * dy * dy,
             wq * u, wq * u * dx, wq * u * dy,
             wq * v, wq * v * dx, wq * v * dy,
             wq * (u * u + v * v)], dim=-1).reshape(-1, _NM))
    acc = torch.zeros((proj_h * proj_w, _NM), device=x_p.device)
    acc.index_add_(0, torch.cat(idxs), torch.cat(vals))
    return acc.reshape(proj_h, proj_w, _NM)


def _gather_moments(moms, qx, qy):
    """The 4 neighbour cells' moments, re-centred on the query point
    (qx, qy) and blended bilinearly: moment translation is linear, so the
    blend is a valid moment vector about the query."""
    Hp, Wp = moms.shape[:2]
    qx = torch.clamp(qx, 0.0, Wp - 1.0)
    qy = torch.clamp(qy, 0.0, Hp - 1.0)
    x0 = torch.floor(qx).to(torch.int64)
    y0 = torch.floor(qy).to(torch.int64)
    fx, fy = qx - x0, qy - y0
    out = 0.0
    for (ddx, ddy), ww in zip(_CORNERS, _corner_weights(fx, fy)):
        xi = torch.clamp(x0 + ddx, max=Wp - 1)
        yi = torch.clamp(y0 + ddy, max=Hp - 1)
        m = moms[yi, xi]                         # (..., 13)
        a = qx - xi.to(torch.float32)            # query in cell-local coords
        b = qy - yi.to(torch.float32)
        S0, Sx, Sy, Sxx, Sxy, Syy, Su, Sux, Suy, Sv, Svx, Svy, Sm2 = m.unbind(-1)
        t = torch.stack(
            [S0,
             Sx - a * S0,
             Sy - b * S0,
             Sxx - 2 * a * Sx + a * a * S0,
             Sxy - a * Sy - b * Sx + a * b * S0,
             Syy - 2 * b * Sy + b * b * S0,
             Su, Sux - a * Su, Suy - b * Su,
             Sv, Svx - a * Sv, Svy - b * Sv,
             Sm2], dim=-1)
        out = out + ww[..., None] * t
    return out


def match_via_projector(
    x_p1, y_p1, dec2_x, dec2_y, w2, proj_w: int, proj_h: int,
    ridge: float = 3e-3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projector-space rendezvous: cam-2 pixel coords seen from cam 1.

    Returns (u2, v2, weight, resid) on the cam-1 grid: ``weight`` is the
    quality-weighted cam-2 evidence at cam 1's projector coordinate (0
    where cam 2 never saw that ray); ``resid`` the RMS residual (cam-2 px)
    of the local linear fit, large where the splat mixes two surfaces."""
    u2g, v2g = _pixel_grid(*dec2_x.shape, dec2_x.device)
    moms = _splat_moments(dec2_x, dec2_y, w2, u2g, v2g, proj_w, proj_h)
    g = _gather_moments(moms, x_p1, y_p1)
    S0 = g[..., 0]
    # ridge on the slope diagonal only: it shrinks the slopes toward the
    # weighted mean where a cell has few samples, and leaves the value
    lam = ridge * S0 + 1e-12
    A = torch.stack([
        torch.stack([S0 + 1e-12, g[..., 1], g[..., 2]], -1),
        torch.stack([g[..., 1], g[..., 3] + lam, g[..., 4]], -1),
        torch.stack([g[..., 2], g[..., 4], g[..., 5] + lam], -1),
    ], -2)
    bu, bv = g[..., 6:9], g[..., 9:12]
    cu, cv = _solve3x3(A, bu), _solve3x3(A, bv)
    # weighted RSS of both linear fits
    rss = g[..., 12] - torch.sum(cu * bu, -1) - torch.sum(cv * bv, -1)
    resid = torch.sqrt(torch.clamp(rss, min=0.0) / torch.clamp(S0, min=1e-12))
    return cu[..., 0], cv[..., 0], S0, resid


def match_via_depth_search(
    x_p1, y_p1, dec2_x, mask2, cam1: Camera, cam2: Camera,
    t_lo: float, t_hi: float, iters: int = 20, coarse: int = 48,
):
    """Scatter-free rendezvous: the depth along each cam-1 ray at which cam
    2's decoded column code under the ray point's projection equals the
    query code. A ``coarse`` uniform sweep of the bracket (clipped per
    pixel to cam 2's frustum, in cam-1 depth) keeps the sign-change
    interval with the smallest endpoint errors; ``iters`` bisection steps
    then localise the root. Returns (u2, v2, t_star)."""
    H, W = x_p1.shape
    u1, v1 = _pixel_grid(H, W, x_p1.device)
    o1, d1 = pixel_to_ray(cam1, u1, v1)
    x2map = torch.where(mask2, dec2_x, 0.0)

    def code_err(t):
        uv2, _ = project(cam2, o1 + t[..., None] * d1)
        return _bilinear(x2map, uv2[..., 0], uv2[..., 1]) - x_p1, uv2

    # per-pixel bracket: each face of cam 2's frustum (Z > 0, 0 <= u, v <=
    # bounds, distortion ignored) is one constraint c0 + c1 t >= 0 on the
    # ray a + t b in cam-2 coordinates; t is the unit ray's parameter, so
    # the caller's z-depth bounds divide by the ray's z component
    H2, W2 = dec2_x.shape
    a = cam2.R @ o1 + cam2.t
    b = torch.einsum("ij,...j->...i", cam2.R, d1)
    d1z = torch.clamp(torch.einsum("j,...j->...", cam1.R[2], d1), min=1e-3)
    lo_px, hi_px = t_lo / d1z, t_hi / d1z
    cons = (
        (a[2] - 1e-3, b[..., 2]),
        (cam2.fx * a[0] + cam2.cx * a[2], cam2.fx * b[..., 0] + cam2.cx * b[..., 2]),
        ((W2 - 1 - cam2.cx) * a[2] - cam2.fx * a[0],
         (W2 - 1 - cam2.cx) * b[..., 2] - cam2.fx * b[..., 0]),
        (cam2.fy * a[1] + cam2.cy * a[2], cam2.fy * b[..., 1] + cam2.cy * b[..., 2]),
        ((H2 - 1 - cam2.cy) * a[2] - cam2.fy * a[1],
         (H2 - 1 - cam2.cy) * b[..., 2] - cam2.fy * b[..., 1]),
    )
    for c0, c1 in cons:
        c0 = c0.expand(H, W)
        root = -c0 / torch.where(c1.abs() < 1e-12, 1e-12, c1)
        lo_px = torch.where(c1 > 0, torch.maximum(lo_px, root), lo_px)
        hi_px = torch.where(c1 < 0, torch.minimum(hi_px, root), hi_px)
        hi_px = torch.where((c1.abs() < 1e-12) & (c0 < 0), lo_px, hi_px)
    hi_px = torch.maximum(hi_px, lo_px)

    dt = (hi_px - lo_px) / (coarse - 1)
    f0, _ = code_err(lo_px)
    big = 1e30
    b_lo, b_hi, b_sc, b_f, f_prev = lo_px, hi_px, torch.full_like(f0, big), f0, f0
    for i in range(1, coarse):
        t_i = lo_px + dt * float(i)
        f_i, _ = code_err(t_i)
        change = torch.sign(f_i) != torch.sign(f_prev)
        score = torch.where(change, f_i.abs() + f_prev.abs(), big)
        better = score < b_sc
        b_lo = torch.where(better, t_i - dt, b_lo)
        b_hi = torch.where(better, t_i, b_hi)
        b_sc = torch.where(better, score, b_sc)
        b_f = torch.where(better, f_prev, b_f)
        f_prev = f_i

    lo, hi, f_lo = b_lo, b_hi, b_f
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        f_mid, _ = code_err(mid)
        same = torch.sign(f_mid) == torch.sign(f_lo)
        lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
        f_lo = torch.where(same, f_mid, f_lo)
    t_star = 0.5 * (lo + hi)
    _, uv2 = code_err(t_star)
    return uv2[..., 0], uv2[..., 1], t_star


def takes_fused(H: int, W: int, proj_w: int, proj_h: int) -> bool:
    """The reference's route rule: K7 when the whole row fits one block and
    the TPU's (bins x pairs) one-hot fits its 8 MiB budget, else the tiled
    route (``crossing_interp``, K6)."""
    return (max(H, W) <= FUSED_MAX_WIDTH
            and max(proj_w, proj_h) * max(H, W) * 4 <= FUSED_BUDGET)


def invert_to_projector(x_p, y_p, mask, quality, white, proj_w: int, proj_h: int, *,
                        dmin: float = 0.125, dmax: float = 2.5, du_max: float = 8.0,
                        flip_u: bool = False, flip_v: bool = False,
                        use_kernel: bool = True):
    """One camera's code maps inverted onto the projector pixel grid: for
    every integer projector coordinate, the sub-pixel camera position
    (u, v) that sees it, with quality and intensity carried along.

    Pass 1 inverts x_p along each image row (monotone in u for a
    horizontally separated rig; ``flip_u`` for mirrored mounts),
    interpolating (u, y_p) and carrying (quality, white) to every integer
    column. Pass 2 inverts the resulting y table along v for each projector
    column (``flip_v`` for upside-down mounts). ``dmax`` (projector px per
    pixel step) gates the code jump of a pair in both passes, so no
    crossing interpolates across a silhouette; the carried code y (pass 1)
    and camera column u (pass 2, ``du_max``) are gated the same way.

    ``use_kernel``: K7 under the reference's route rule (``takes_fused``),
    else ``crossing_interp`` through K6; False: both passes on the plain
    contraction. Returns (valid, u, v, q, w), all (proj_h, proj_w)."""
    H, W = x_p.shape
    interp = (True, True, False, False)
    u_i = _pixel_grid(H, W, x_p.device)[0]
    if flip_u:
        x_p, y_p, mask, quality, white, u_i = (
            torch.flip(a, dims=(1,)) for a in (x_p, y_p, mask, quality, white, u_i))
    fused = use_kernel and takes_fused(H, W, proj_w, proj_h)

    def crossing_pass(code, valid, channels, num_bins: int, gate):
        if fused:
            return crossing_interp_fused(code.contiguous(), valid.contiguous(), channels,
                                         num_bins, interp, gates=(gate,), dmin=dmin,
                                         dmax=dmax)
        return crossing_interp(code, valid, channels, num_bins, interp, dmin, dmax,
                               use_kernel=use_kernel,
                               pair_gate=gate_mask(channels, (gate,)))

    cnt1, (u1, y1, q1, w1) = crossing_pass(
        x_p, mask, torch.stack([u_i, y_p, quality, white]), proj_w, (1, dmax))
    code2, valid2 = y1.T, (cnt1 > 0.5).T                  # (proj_w, H)
    v_i2 = _pixel_grid(proj_w, H, x_p.device)[0]
    u2c, q2c, w2c = u1.T, q1.T, w1.T
    if flip_v:
        code2, valid2, v_i2, u2c, q2c, w2c = (
            torch.flip(a, dims=(1,)) for a in (code2, valid2, v_i2, u2c, q2c, w2c))
    cnt2, (u_t, v_t, q_t, w_t) = crossing_pass(
        code2, valid2, torch.stack([u2c, v_i2, q2c, w2c]), proj_h, (0, du_max))
    return (cnt2 > 0.5).T, u_t.T, v_t.T, q_t.T, w_t.T


def _code_edge_mask(x_p, y_p, mask, tol: float):
    """False at code-discontinuity pixels: a silhouette-edge pixel blends
    two surfaces' codes and can counterfeit the code of a point the camera
    cannot see. Such a pixel's code jumps by ``tol`` projector px or more to
    a 4-neighbour. Neighbours outside ``mask`` do not vote, and neither do
    the wrapped-around rows and columns the roll drags in."""
    jump = torch.zeros_like(x_p)
    m = mask.to(torch.float32)
    for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
        dy, dx = (sh, 0) if ax == 0 else (0, sh)
        nx = torch.roll(x_p, sh, dims=ax)
        ny = torch.roll(y_p, sh, dims=ax)
        nm = _shift_zero(m, dy, dx) > 0.5
        d = (nx - x_p).abs() + (ny - y_p).abs()
        jump = torch.maximum(jump, torch.where(nm, d, 0.0))
    return jump < tol


def _bilinear(img, x, y):
    """Clamped bilinear sample of an (H, W) map at float coords."""
    H, W = img.shape
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    # clamping the indices too keeps a NaN coordinate's gather in bounds
    x0 = torch.clamp(x0f.to(torch.int64), 0, W - 1)
    y0 = torch.clamp(y0f.to(torch.int64), 0, H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)


def _decode(frames, cam: Camera, cfg: PatternConfig, dec: DecodeConfig) -> DecodeResult:
    """K1's decode_only route on a CUDA tensor where the coding allows it;
    otherwise (and on the CPU, as the reference off the TPU) decode_stack."""
    if (frames.device.type == "cuda" and cfg.coding == "gray_phase"
            and cfg.use_inverse and cfg.phase_steps):
        o = fused_decode_triangulate(frames, cam, None, cfg, dec, decode_only=True)
        return DecodeResult(x_p=o.x_p, y_p=o.y_p, mask=o.mask > 0.5, quality=o.quality)
    return decode_stack(frames, cfg, dec)


def _depth(cam: Camera, pts):
    return torch.einsum("j,...j->...", cam.R[2], pts) + cam.t[2]


def reconstruct_two_camera(
    frames1,
    frames2,
    cam1: Camera,
    cam2: Camera,
    cfg: PatternConfig,
    dec: DecodeConfig = DecodeConfig(),
    rec: ReconstructConfig = ReconstructConfig(),
    max_ray_gap: float = 1.0,
    min_weight: float = 0.05,
    max_resid: float = 1.5,
    code_tol: float = 0.5,
    edge_tol: float = 3.0,
    method: str = "merge",
    search_iters: int = 24,
    flip_u: bool = False,
    flip_v: bool = False,
    merge_dmax: float = 2.5,
    merge_kernel: bool = True,
    unsafe_search: bool = False,
) -> ScanCloud:
    """Decode both stacks, rendezvous in projector space, triangulate cam-1
    x cam-2 rays. The projector's calibration is not an input.

    ``method``: "merge" (default; the cloud on the projector grid;
    ``merge_dmax`` is the anti-phantom jump gate of ``invert_to_projector``
    and ``merge_kernel=False`` takes the plain contraction), or the oracles
    "splat" and "search" (the cloud on the cam-1 grid; "search" sweeps
    [rec.min_depth, rec.max_depth]). ``max_ray_gap`` (scene units) gates
    the rays' common-perpendicular distance; ``min_weight`` and
    ``max_resid`` (cam-2 px) the splat evidence and fit residual;
    ``code_tol`` (projector px) the left-right consistency of both code
    axes; ``edge_tol`` the code-discontinuity mask of both cameras.
    ``unsafe_search`` is accepted and ignored: the reference's fence
    guards a TPU device fault.

    The call is one ``scan`` span of the recorder (``slr_torch.observability``):
    ``merge.decode`` a camera, ``merge.edges``, and for the merge
    ``merge.invert`` a camera and ``merge.midpoint``."""
    if not cfg.row_gray_bits:
        raise ValueError(
            "two-camera mode needs both projector axes coded: set "
            "row_gray_bits (+ optionally row_phase_steps) in PatternConfig")
    if method not in ("merge", "splat", "search"):
        raise ValueError(f"unknown two-camera method {method!r}")
    with obs.span("scan"):
        with obs.span("merge.decode"):
            r1 = _decode(frames1, cam1, cfg, dec)
        with obs.span("merge.decode"):
            r2 = _decode(frames2, cam2, cfg, dec)
        if r1.y_p is None:
            raise ValueError("decode produced no projector-row coordinate")

        # both sides drop code-discontinuity (silhouette-blend) pixels
        with obs.span("merge.edges"):
            edge1 = _code_edge_mask(r1.x_p, r1.y_p, r1.mask, edge_tol)
            edge2 = _code_edge_mask(r2.x_p, r2.y_p, r2.mask, edge_tol)
        if method == "merge":
            found = []
            for r, edge, f in ((r1, edge1, frames1), (r2, edge2, frames2)):
                with obs.span("merge.invert"):
                    found.append(invert_to_projector(
                        r.x_p, r.y_p, r.mask & edge, r.quality, _white_color(f),
                        cfg.proj_width, cfg.proj_height, dmax=merge_dmax, flip_u=flip_u,
                        flip_v=flip_v, use_kernel=merge_kernel))
            m1, m2 = found
            with obs.span("merge.midpoint"):
                o1m, d1m = pixel_to_ray(cam1, m1[1], m1[2])
                o2m, d2m = pixel_to_ray(cam2, m2[1], m2[2])
                pts, gap = triangulate_midpoint(o1m, d1m, o2m, d2m)
                depth1 = _depth(cam1, pts)
                mk = (m1[0] & m2[0] & (gap < max_ray_gap)
                      & (depth1 > rec.min_depth) & (depth1 < rec.max_depth))
                pts = torch.where(mk[..., None], pts, 0.0)
                quality = torch.where(mk, torch.minimum(m1[3], m2[3]), 0.0)
                xp_grid = _pixel_grid(*mk.shape, mk.device)[0]
                return ScanCloud(points=pts, mask=mk, colors=m1[4], quality=quality,
                                 x_p=xp_grid)

        gw = resid = None
        if method == "search":
            u2, v2, _ = match_via_depth_search(
                r1.x_p, r1.y_p, r2.x_p, r2.mask & edge2, cam1, cam2,
                t_lo=rec.min_depth, t_hi=rec.max_depth, iters=search_iters)
        else:
            w2 = torch.where(r2.mask & edge2, torch.clamp(r2.quality, min=1e-6), 0.0)
            u2, v2, gw, resid = match_via_projector(
                r1.x_p, r1.y_p, r2.x_p, r2.y_p, w2, cfg.proj_width, cfg.proj_height)

        u1, v1 = _pixel_grid(*r1.x_p.shape, r1.x_p.device)
        o1, d1 = pixel_to_ray(cam1, u1, v1)
        o2, d2 = pixel_to_ray(cam2, u2, v2)
        pts, gap = triangulate_midpoint(o1, d1, o2, d2)
        # left-right consistency: cam 2's decode at the matched pixel must carry
        # the query's projector code (all 4 sample neighbours valid)
        x_back = _bilinear(torch.where(r2.mask, r2.x_p, 0.0), u2, v2)
        y_back = _bilinear(torch.where(r2.mask, r2.y_p, 0.0), u2, v2)
        m_back = _bilinear(r2.mask.to(torch.float32), u2, v2)
        consistent = ((m_back > 0.999) & ((x_back - r1.x_p).abs() < code_tol)
                      & ((y_back - r1.y_p).abs() < code_tol))
        depth1 = _depth(cam1, pts)
        mask = (r1.mask & edge1 & consistent & (gap < max_ray_gap)
                & (depth1 > rec.min_depth) & (depth1 < rec.max_depth))
        if gw is not None:
            mask = mask & (gw > min_weight) & (resid < max_resid)
        pts = torch.where(mask[..., None], pts, 0.0)
        q_match = r1.quality if gw is None else torch.minimum(r1.quality, gw)
        return ScanCloud(points=pts, mask=mask, colors=_white_color(frames1),
                         quality=torch.where(mask, q_match, 0.0), x_p=r1.x_p)
