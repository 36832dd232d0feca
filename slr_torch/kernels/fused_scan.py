"""Fused decode -> unwrap -> triangulate: the single-camera scan kernels.

Port of ``slr/kernels/fused_scan.py``, both of its kernels:

- K1, ``fused_decode_triangulate``: the (F, H, W) captured stack is read
  once and the kernel writes the 3-D point map, validity mask, quality,
  ``x_p`` and ``y_p`` directly. Gray decode with per-bit certainty and an
  N-step phase with the cyclic half-shifted temporal unwrap, or Gray only
  (``phase_steps=0``, half-stripe centres), or the multi-frequency
  hierarchical phase unwrap; projector rows when they are coded; then
  camera-ray undistortion and ray x projector-column-plane triangulation,
  or the midpoint of the camera and (undistorted) projector rays when rows
  are coded, or nothing (``decode_only``: points are 0).
- K2, ``fused_decode_triangulate_hdr``: an (E, F, H, W) exposure bracket.
  Per pixel, each exposure's phase modulation and usability (contrast above
  ``tau_black``, white below saturation) are computed; the Gray bits come
  from the best usable exposure (the first wins ties); the phase sums are
  modulation-weighted over the usable exposures (``fuse="sum"``) or taken
  from the best one (``fuse="select"``). Then K1's decode and geometry.

Frames are float32 in [0, 1] or raw camera integers (uint8, or uint16 with
``bit_depth`` bits). Integer stacks are compared in raw ADC counts against
thresholds rounded on the host, ``int(round(tau * m))`` with ``m`` the ADC
maximum, exactly as the TPU kernel does; only the phase frames become
float, and the modulation is rescaled by ``1/m`` at the end.

Each wrapper takes the plain PyTorch version (``*_reference``) for a CPU
tensor and launches the hand-written kernel ``csrc/fused_scan.cu`` for a
CUDA tensor, or raises. Contract of both routes: inverse Gray patterns
(K1: unless multifreq), the camera at the world origin (R = I, t = 0)
unless ``decode_only``; K2 takes gray_phase coding with phase steps only.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from slr_torch import observability as obs
from slr_torch.codec.graycode import gray_decode_int
from slr_torch.config import DecodeConfig, PatternConfig
from slr_torch.geom.camera import Camera, undistort_iterative
from slr_torch.kernels.build import bind, expect, launch

TWO_PI = 2.0 * math.pi
MAX_STEPS = 32   # SLR_MAX_STEPS in csrc/fused_scan.cu
MAX_LEVELS = 8   # SLR_MAX_LEVELS
DTYPES = {torch.float32: 0, torch.uint8: 1, torch.uint16: 2}
GEOMETRIES = ("plane", "midpoint", "decode_only")
FUSES = ("sum", "select")


class FusedScanOut(NamedTuple):
    points: torch.Tensor   # (3, H, W) world-frame points (0 where invalid)
    mask: torch.Tensor     # (H, W) f32 0/1 validity
    quality: torch.Tensor  # (H, W) phase modulation B (Gray only: contrast)
    x_p: torch.Tensor      # (H, W) decoded sub-pixel projector column
    y_p: torch.Tensor      # (H, W) decoded projector row (0: not coded)


class _ScanParams(ctypes.Structure):
    """Mirror of ``SlrScanParams`` in csrc/fused_scan.cu."""

    _fields_ = [(name, ctypes.c_int32) for name in (
        "height", "width", "dtype", "geometry", "multifreq", "bits",
        "row_bits", "steps", "row_steps", "mf_levels", "undistort_iters",
        "exposures", "fuse", "tau_black_i", "tau_white_i", "tau_sat_i")] + [
        (name, ctypes.c_float) for name in (
            "tau_black", "tau_white", "tau_sat", "tau_mod", "mod_scale",
            "row_mod_scale", "mod_out_scale", "pitch", "xp_scale", "w_coded",
            "w_fold", "row_pitch", "yp_scale", "h_coded", "h_fold",
            "mf_xp_scale", "mf_period", "mf_fold", "row_offset", "zmin",
            "zmax", "fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3",
            "pfx", "pfy", "pcx", "pcy", "q1", "q2", "s1", "s2", "q3")] + [
        ("R", ctypes.c_float * 9), ("C", ctypes.c_float * 3),
        ("mf_ratio", ctypes.c_float * MAX_LEVELS),
        ("sin_d", ctypes.c_float * MAX_STEPS),
        ("cos_d", ctypes.c_float * MAX_STEPS),
        ("row_sin_d", ctypes.c_float * MAX_STEPS),
        ("row_cos_d", ctypes.c_float * MAX_STEPS)]


def _f32(x) -> float:
    return float(np.float32(x))


def _geometry(cfg: PatternConfig, decode_only: bool) -> str:
    if decode_only:
        return "decode_only"
    return "midpoint" if cfg.row_gray_bits else "plane"


def _check_frames(frames, cfg: PatternConfig, dims: int):
    if frames.dtype not in DTYPES:
        raise ValueError(f"the fused scan takes float32, uint8 or uint16 "
                         f"frames, got {frames.dtype}")
    if frames.dim() != dims or frames.shape[-3] != cfg.num_frames:
        want = "(E, F, H, W)" if dims == 4 else "(F, H, W)"
        raise ValueError(f"frames must be {want} with F = {cfg.num_frames}, "
                         f"got {tuple(frames.shape)}")
    if max(cfg.phase_steps, cfg.row_phase_steps) > MAX_STEPS:
        raise ValueError(f"at most {MAX_STEPS} phase steps")
    if cfg.coding == "multifreq" and cfg.mf_levels > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} multifreq levels")


def _check_contract(frames, proj, cfg: PatternConfig, decode_only: bool):
    _check_frames(frames, cfg, 3)
    if cfg.coding != "multifreq" and not cfg.use_inverse:
        raise ValueError("the fused scan needs inverse Gray patterns "
                         "(use_inverse=True)")
    if proj is None and not decode_only:
        raise ValueError("a projector model is required to triangulate")


def _check_hdr_contract(stacks, cfg: PatternConfig, fuse: str):
    if (cfg.coding != "gray_phase" or not cfg.use_inverse
            or cfg.phase_steps <= 0):
        raise ValueError("the fused HDR scan needs gray_phase coding with "
                         "inverse patterns and phase_steps > 0: the "
                         "exposure choice is by phase modulation")
    if fuse not in FUSES:
        raise ValueError(f"fuse must be one of {FUSES}, got {fuse!r}")
    _check_frames(stacks, cfg, 4)


def _check_camera_at_origin(R, t):
    if not (torch.equal(R, torch.eye(3, dtype=R.dtype, device=R.device))
            and not torch.any(t)):
        raise ValueError("the fused scan needs the camera at the world "
                         "origin (R = I, t = 0)")


def _constants(cfg: PatternConfig, dec: DecodeConfig, dtype,
               bit_depth: Optional[int] = None, saturation: float = 0.98):
    """Thresholds, phase weights and unwrap scalars, rounded to float32
    once on the host, so that the kernel and the plain version use the same
    values. Integer stacks get integer thresholds in raw counts."""
    if dtype == torch.float32:
        tau = dict(tau_black=_f32(dec.black_threshold),
                   tau_white=_f32(dec.white_threshold),
                   tau_sat=_f32(saturation),
                   tau_mod=_f32(dec.modulation_threshold), mod_out_scale=1.0)
    else:
        m = (1 << bit_depth) - 1 if bit_depth is not None else torch.iinfo(dtype).max
        tau = dict(tau_black=int(round(dec.black_threshold * m)),
                   tau_white=int(round(dec.white_threshold * m)),
                   tau_sat=int(round(saturation * m)),
                   tau_mod=_f32(dec.modulation_threshold * m),
                   mod_out_scale=_f32(1.0 / m))

    def weights(steps):
        d = [TWO_PI * k / steps for k in range(steps)]
        return [_f32(math.sin(x)) for x in d], [_f32(math.cos(x)) for x in d]

    def cyclic(pitch, bits):
        """(pitch, pitch / 2 pi, coded period, its top-edge fold threshold)
        in float32 arithmetic, as the TPU kernel computes them."""
        pitch = np.float32(pitch)
        coded = pitch * np.float32(1 << bits)
        return (float(pitch), float(pitch / np.float32(TWO_PI)), float(coded),
                float(coded - np.float32(0.5)))

    c = dict(tau)
    c["sin_d"], c["cos_d"] = weights(cfg.phase_steps)
    c["row_sin_d"], c["row_cos_d"] = weights(cfg.row_phase_steps)
    c["mod_scale"] = _f32(2.0 / cfg.phase_steps) if cfg.phase_steps else 0.0
    c["row_mod_scale"] = (_f32(2.0 / cfg.row_phase_steps)
                          if cfg.row_phase_steps else 0.0)
    c["pitch"], c["xp_scale"], c["w_coded"], c["w_fold"] = cyclic(
        cfg.fringe_pitch, cfg.gray_bits)
    if cfg.row_gray_bits:
        c["row_pitch"], c["yp_scale"], c["h_coded"], c["h_fold"] = cyclic(
            cfg.row_fringe_pitch, cfg.row_gray_bits)
    else:
        c["row_pitch"] = c["yp_scale"] = c["h_coded"] = c["h_fold"] = 0.0
    if cfg.coding == "multifreq":
        p = cfg.mf_pitches
        c["mf_ratio"] = [0.0] + [_f32(p[i - 1] / p[i]) for i in range(1, len(p))]
        c["mf_xp_scale"] = _f32(p[-1] / TWO_PI)
        c["mf_period"] = _f32(p[0])
        c["mf_fold"] = _f32(p[0] - 0.5)
    else:
        c["mf_ratio"] = []
        c["mf_xp_scale"] = c["mf_period"] = c["mf_fold"] = 0.0
    return c


# ---------------------------------------------------------------------------
# The plain PyTorch versions: the kernels' arithmetic in the same order, on
# any device. Each helper mirrors the device function of the same name in
# csrc/fused_scan.cu.


def _loaders(frames):
    """(raw, rawf): frame i in raw units (int32 for integer stacks, which
    torch cannot subtract or compare as uint16) and as float32."""
    if frames.is_floating_point():
        def raw(i):
            return frames[i]
        return raw, raw

    def raw(i):
        return frames[i].to(torch.int32)

    return raw, lambda i: raw(i).to(torch.float32)


def _gray_block(raw, first: int, bits: int, tau_white, certain):
    """MSB-first Gray bits at frames [first, first+bits) against their
    inverses at [first+bits, first+2 bits); (binary code, certainty)."""
    g = torch.zeros(certain.shape, dtype=torch.int32, device=certain.device)
    for i in range(bits):
        diff = raw(first + i) - raw(first + bits + i)
        g = (g << 1) | (diff > 0).to(torch.int32)
        certain = certain & (diff.abs() > tau_white)
    return gray_decode_int(g, bits), certain


def _phase_sums(rawf, first: int, sin_d, cos_d, shape, device):
    S = torch.zeros(shape, device=device)
    C = torch.zeros(shape, device=device)
    for k in range(len(sin_d)):
        fk = rawf(first + k)
        S = S + fk * sin_d[k]
        C = C + fk * cos_d[k]
    return S, C


def _wrapped_phase(S, C):
    phi = torch.atan2(S, C)
    return torch.where(phi < 0.0, phi + TWO_PI, phi)


def _unwrap_cyclic(phi, code, bits: int, scale, period, fold):
    """Cyclic half-shifted temporal unwrap: order = (code - [phi >= pi])
    mod 2^bits, then the top edge folded back by one coded period."""
    order = code - (phi >= math.pi).to(torch.int32)
    order = torch.where(order < 0, order + (1 << bits), order)
    x = (phi + TWO_PI * order.to(torch.float32)) * scale
    return torch.where(x > fold, x - period, x)


def _gray_phase_decode(raw, cfg, c, certain, contrast, S, C, Sr, Cr):
    """Gray(+inverse) decode, N-step phase (or Gray-only stripe centres),
    and the projector rows when coded. The phase sums are given: K2 fuses
    them over its bracket. Returns (x_p, y_p, valid, quality)."""
    bits, row_bits = cfg.gray_bits, cfg.row_gray_bits
    code, certain = _gray_block(raw, 2, bits, c["tau_white"], certain)
    if row_bits:
        row_code, certain = _gray_block(raw, 2 + 2 * bits, row_bits,
                                        c["tau_white"], certain)
    if cfg.phase_steps:
        phi = _wrapped_phase(S, C)
        mod = c["mod_scale"] * torch.sqrt(S * S + C * C)
        valid = certain & (mod > c["tau_mod"])
        quality = mod * c["mod_out_scale"]
        x_p = _unwrap_cyclic(phi, code, bits, c["xp_scale"], c["w_coded"],
                             c["w_fold"])
    else:
        x_p = (code.to(torch.float32) + 0.5) * c["pitch"]
        quality = contrast.to(torch.float32) * c["mod_out_scale"]
        valid = certain
    y_p = torch.zeros_like(x_p)
    if row_bits:
        if cfg.row_phase_steps:
            rphi = _wrapped_phase(Sr, Cr)
            rmod = c["row_mod_scale"] * torch.sqrt(Sr * Sr + Cr * Cr)
            valid = valid & (rmod > c["tau_mod"])
            y_p = _unwrap_cyclic(rphi, row_code, row_bits, c["yp_scale"],
                                 c["h_coded"], c["h_fold"])
        else:
            y_p = (row_code.to(torch.float32) + 0.5) * c["row_pitch"]
    return x_p, y_p, valid, quality


def _multifreq_decode(rawf, cfg, c, certain):
    """Hierarchical multi-frequency unwrap; no Gray frames, no rows."""
    steps = cfg.phase_steps
    valid = certain
    for level in range(cfg.mf_levels):
        S, C = _phase_sums(rawf, 2 + level * steps, c["sin_d"], c["cos_d"],
                           certain.shape, certain.device)
        phi = _wrapped_phase(S, C)
        B = c["mod_scale"] * torch.sqrt(S * S + C * C)
        valid = valid & (B > c["tau_mod"])
        if level == 0:
            Phi, mod = phi, B   # the coarsest pitch spans W: absolute
        else:
            k = torch.round((Phi * c["mf_ratio"][level] - phi) / TWO_PI)
            Phi = phi + TWO_PI * k
            mod = torch.minimum(mod, B)
    x_p = Phi * c["mf_xp_scale"]
    x_p = torch.where(x_p > c["mf_fold"], x_p - c["mf_period"], x_p)
    return x_p, torch.zeros_like(x_p), valid, mod * c["mod_out_scale"]


def _triangulate_write(decoded, cam: Camera, proj: Camera, geometry: str,
                       z_bounds, undistort_iters: int, row_offset: float):
    """Camera ray, plane or midpoint triangulation, depth bounds, outputs."""
    x_p, y_p, valid, quality = decoded
    H, W = x_p.shape
    dev = x_p.device
    if geometry == "decode_only":
        return FusedScanOut(points=torch.zeros((3, H, W), device=dev),
                            mask=valid.to(torch.float32), quality=quality,
                            x_p=x_p, y_p=y_p)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    xn, yn = undistort_iterative((u - cam.cx) / cam.fx,
                                 (v + row_offset - cam.cy) / cam.fy,
                                 cam.dist, undistort_iters)
    R, Cw = proj.R, proj.center
    if geometry == "plane":
        # ray x projector column plane: n_p = (1, 0, -xnp), n_w = R^T n_p
        xnp = (x_p - proj.cx) / proj.fx
        nwx = R[0, 0] - R[2, 0] * xnp
        nwy = R[0, 1] - R[2, 1] * xnp
        nwz = R[0, 2] - R[2, 2] * xnp
        den = nwx * xn + nwy * yn + nwz
        den = torch.where(den.abs() < 1e-12, 1e-12, den)
        lam = (nwx * Cw[0] + nwy * Cw[1] + nwz * Cw[2]) / den
        X = torch.stack([xn * lam, yn * lam, lam])
    else:
        # midpoint of the common perpendicular of the camera ray
        # (0, (xn, yn, 1)) and the undistorted projector ray (C_p, R^T d_p)
        xnp, ynp = undistort_iterative((x_p - proj.cx) / proj.fx,
                                       (y_p - proj.cy) / proj.fy,
                                       proj.dist, undistort_iters)
        d2x = R[0, 0] * xnp + R[1, 0] * ynp + R[2, 0]
        d2y = R[0, 1] * xnp + R[1, 1] * ynp + R[2, 1]
        d2z = R[0, 2] * xnp + R[1, 2] * ynp + R[2, 2]
        a = xn * xn + yn * yn + 1.0
        bb = xn * d2x + yn * d2y + d2z
        cc = d2x * d2x + d2y * d2y + d2z * d2z
        dd = -(xn * Cw[0] + yn * Cw[1] + Cw[2])
        e = -(d2x * Cw[0] + d2y * Cw[1] + d2z * Cw[2])
        den = a * cc - bb * bb
        den = torch.where(den.abs() < 1e-12, 1e-12, den)
        s = (bb * e - cc * dd) / den
        t = (a * e - bb * dd) / den
        X = torch.stack([0.5 * (s * xn + Cw[0] + t * d2x),
                         0.5 * (s * yn + Cw[1] + t * d2y),
                         0.5 * (s + Cw[2] + t * d2z)])
        lam = X[2]
    valid = valid & (lam > z_bounds[0]) & (lam < z_bounds[1])
    return FusedScanOut(points=torch.where(valid, X, 0.0),
                        mask=valid.to(torch.float32), quality=quality,
                        x_p=x_p, y_p=y_p)


def fused_decode_triangulate_reference(
    frames, cam: Camera, proj: Optional[Camera], cfg: PatternConfig,
    dec: DecodeConfig, z_bounds=(1.0, 1e4), undistort_iters: int = 8,
    bit_depth: Optional[int] = None, row_offset: float = 0.0,
    decode_only: bool = False,
) -> FusedScanOut:
    """Plain PyTorch version of K1, the same arithmetic in the same order."""
    _check_contract(frames, proj, cfg, decode_only)
    if not decode_only:
        _check_camera_at_origin(cam.R.cpu(), cam.t.cpu())
    c = _constants(cfg, dec, frames.dtype, bit_depth)
    raw, rawf = _loaders(frames)
    contrast = raw(0) - raw(1)
    certain = contrast > c["tau_black"]
    if cfg.coding == "multifreq":
        decoded = _multifreq_decode(rawf, cfg, c, certain)
    else:
        base = 2 + 2 * cfg.gray_bits + 2 * cfg.row_gray_bits
        S, C = _phase_sums(rawf, base, c["sin_d"], c["cos_d"],
                           certain.shape, frames.device)
        Sr, Cr = _phase_sums(rawf, base + cfg.phase_steps, c["row_sin_d"],
                             c["row_cos_d"], certain.shape, frames.device)
        decoded = _gray_phase_decode(raw, cfg, c, certain, contrast, S, C, Sr, Cr)
    return _triangulate_write(decoded, cam, proj, _geometry(cfg, decode_only),
                              z_bounds, undistort_iters, row_offset)


def fused_decode_triangulate_hdr_reference(
    stacks, cam: Camera, proj: Camera, cfg: PatternConfig, dec: DecodeConfig,
    saturation: float = 0.98, z_bounds=(1.0, 1e4), undistort_iters: int = 8,
    bit_depth: Optional[int] = None, row_offset: float = 0.0,
    fuse: str = "sum",
) -> FusedScanOut:
    """Plain PyTorch version of K2. One pass over the exposures, as the
    kernel makes it: the running best (score > best: the first exposure
    wins ties) and the running sums of B*S, B*C and B over the usable ones;
    the fused sums are those over the sum of B."""
    _check_hdr_contract(stacks, cfg, fuse)
    _check_camera_at_origin(cam.R.cpu(), cam.t.cpu())
    E, _, H, W = stacks.shape
    dev = stacks.device
    c = _constants(cfg, dec, stacks.dtype, bit_depth, saturation)
    base = 2 + 2 * cfg.gray_bits + 2 * cfg.row_gray_bits
    loaders = [_loaders(stacks[e]) for e in range(E)]
    best = torch.zeros((H, W), dtype=torch.int32, device=dev)
    zero = torch.zeros((H, W), device=dev)
    sums = [zero] * 5   # sum of w, w*S, w*C, w*Sr, w*Cr
    for e, (raw, rawf) in enumerate(loaders):
        S, C = _phase_sums(rawf, base, c["sin_d"], c["cos_d"], (H, W), dev)
        Sr, Cr = _phase_sums(rawf, base + cfg.phase_steps, c["row_sin_d"],
                             c["row_cos_d"], (H, W), dev)
        B = c["mod_scale"] * torch.sqrt(S * S + C * C)
        white = raw(0)
        usable = ((white - raw(1)) > c["tau_black"]) & (white < c["tau_sat"])
        score = torch.where(usable, B, -1.0)
        if e == 0:
            best_score, chosen = score, [S, C, Sr, Cr]
        else:
            upd = score > best_score
            best = torch.where(upd, e, best)
            best_score = torch.where(upd, score, best_score)
            chosen = [torch.where(upd, x, y) for x, y in zip((S, C, Sr, Cr), chosen)]
        w = torch.where(usable, B, 0.0)
        sums = [sums[0] + w] + [acc + w * x for acc, x in zip(sums[1:], (S, C, Sr, Cr))]
    if fuse == "sum":
        norm = torch.clamp_min(sums[0], 1e-20)
        chosen = [x / norm for x in sums[1:]]

    def raw_best(i):
        out = loaders[0][0](i)
        for e in range(1, E):
            out = torch.where(best == e, loaders[e][0](i), out)
        return out

    # phase_steps > 0 here, so the contrast (Gray-only quality) is unused
    decoded = _gray_phase_decode(raw_best, cfg, c, best_score >= 0.0, None,
                                 *chosen)
    return _triangulate_write(decoded, cam, proj, _geometry(cfg, False),
                              z_bounds, undistort_iters, row_offset)


# ---------------------------------------------------------------------------
# The CUDA route.


def scan_params(cam: Camera, proj: Optional[Camera], cfg: PatternConfig,
                dec: DecodeConfig, z_bounds, undistort_iters: int,
                height: int, width: int, *, dtype=torch.float32,
                bit_depth: Optional[int] = None, row_offset: float = 0.0,
                decode_only: bool = False, exposures: int = 0,
                saturation: float = 0.98, fuse: str = "sum") -> _ScanParams:
    """The kernels' parameter block, built on the host (``exposures`` > 0:
    K2's). The calibration is brought to the host in one transfer."""
    proj = cam if proj is None else proj   # decode_only reads no projector
    fields = [x.reshape(-1).to(torch.float32) for x in (*cam, *proj)]
    with obs.wait("params.read"):
        flat = torch.cat(fields).cpu()
    flat = flat.split([f.numel() for f in fields])
    cam_h = Camera(*(x.reshape(s.shape) for x, s in zip(flat[:7], cam)))
    proj_h = Camera(*(x.reshape(s.shape) for x, s in zip(flat[7:], proj)))
    if not decode_only:
        _check_camera_at_origin(cam_h.R, cam_h.t)
    c = _constants(cfg, dec, dtype, bit_depth, saturation)
    integer = dtype != torch.float32
    p = _ScanParams(
        height=height, width=width, dtype=DTYPES[dtype],
        geometry=GEOMETRIES.index(_geometry(cfg, decode_only)),
        multifreq=int(cfg.coding == "multifreq"),
        bits=cfg.gray_bits, row_bits=cfg.row_gray_bits,
        steps=cfg.phase_steps, row_steps=cfg.row_phase_steps,
        mf_levels=cfg.mf_levels,
        undistort_iters=undistort_iters, exposures=exposures,
        fuse=FUSES.index(fuse),
        tau_mod=c["tau_mod"], mod_scale=c["mod_scale"],
        row_mod_scale=c["row_mod_scale"], mod_out_scale=c["mod_out_scale"],
        row_offset=row_offset, zmin=z_bounds[0], zmax=z_bounds[1],
        fx=float(cam_h.fx), fy=float(cam_h.fy),
        cx=float(cam_h.cx), cy=float(cam_h.cy),
        pfx=float(proj_h.fx), pfy=float(proj_h.fy),
        pcx=float(proj_h.cx), pcy=float(proj_h.cy),
    )
    for name in ("tau_black", "tau_white", "tau_sat"):
        setattr(p, name + "_i" if integer else name, c[name])
    for name in ("pitch", "xp_scale", "w_coded", "w_fold", "row_pitch",
                 "yp_scale", "h_coded", "h_fold", "mf_xp_scale", "mf_period",
                 "mf_fold"):
        setattr(p, name, c[name])
    p.k1, p.k2, p.p1, p.p2, p.k3 = cam_h.dist.tolist()
    p.q1, p.q2, p.s1, p.s2, p.q3 = proj_h.dist.tolist()
    p.R[:] = proj_h.R.reshape(-1).tolist()
    p.C[:] = proj_h.center.tolist()
    p.mf_ratio[:len(c["mf_ratio"])] = c["mf_ratio"]
    for name in ("sin_d", "cos_d", "row_sin_d", "row_cos_d"):
        getattr(p, name)[:len(c[name])] = c[name]
    return p


def _frames_per_exposure(p: _ScanParams) -> int:
    if p.multifreq:
        return 2 + p.mf_levels * p.steps
    return 2 + 2 * p.bits + 2 * p.row_bits + p.steps + p.row_steps


_sig = (ctypes.c_int, [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
_bound = bind("fused_scan", {"slr_fused_scan": _sig, "slr_fused_scan_hdr": _sig,
                             "slr_fused_scan_params_size": (ctypes.c_int, [])})


@functools.cache
def library() -> ctypes.CDLL:
    """``csrc/fused_scan.cu`` (K1 and K2), its parameter block's layout
    checked against ``_ScanParams``."""
    lib = _bound()
    if lib.slr_fused_scan_params_size() != ctypes.sizeof(_ScanParams):
        raise RuntimeError("SlrScanParams in csrc/fused_scan.cu and "
                           "_ScanParams disagree on their layout")
    return lib


def _launch(fn: str, what: str, counter: str, frames, params: _ScanParams) -> FusedScanOut:
    want = ((params.exposures,) if params.exposures else ()) + (
        _frames_per_exposure(params), params.height, params.width)
    expect(what, (frames, want, list(DTYPES)[params.dtype]))
    out = torch.empty((7, *want[-2:]), dtype=torch.float32, device=frames.device)
    launch(library(), fn, what, frames.device, frames.data_ptr(), out.data_ptr(),
           ctypes.addressof(params), counter=counter)
    return FusedScanOut(points=out[:3], mask=out[3], quality=out[4],
                        x_p=out[5], y_p=out[6])


def launch_fused_scan(frames, params: _ScanParams) -> FusedScanOut:
    """Launch K1 on PyTorch's current stream (no sync)."""
    if params.exposures:
        raise ValueError("an HDR parameter block: use launch_fused_scan_hdr")
    return _launch("slr_fused_scan", "K1", "launches.k1", frames, params)


def launch_fused_scan_hdr(stacks, params: _ScanParams) -> FusedScanOut:
    """Launch K2 on PyTorch's current stream (no sync)."""
    if not params.exposures:
        raise ValueError("a single-exposure parameter block: use launch_fused_scan")
    return _launch("slr_fused_scan_hdr", "K2", "launches.k2", stacks, params)


def fused_decode_triangulate(
    frames, cam: Camera, proj: Optional[Camera], cfg: PatternConfig,
    dec: DecodeConfig, z_bounds=(1.0, 1e4), undistort_iters: int = 8,
    bit_depth: Optional[int] = None, row_offset: float = 0.0,
    decode_only: bool = False,
) -> FusedScanOut:
    """One-pass scan reconstruction (K1). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (counted as ``launches.k1``).
    ``bit_depth``: the ADC's bits for integer frames in a wider container
    (12-bit data in uint16); ``row_offset``: the global row of frame row 0;
    ``decode_only``: codes only, points 0, no projector needed."""
    _check_contract(frames, proj, cfg, decode_only)
    if frames.device.type == "cpu":
        return fused_decode_triangulate_reference(
            frames, cam, proj, cfg, dec, z_bounds, undistort_iters, bit_depth,
            row_offset, decode_only)
    H, W = frames.shape[-2:]
    with obs.span("k1.params"):
        params = scan_params(cam, proj, cfg, dec, z_bounds, undistort_iters, H, W,
                             dtype=frames.dtype, bit_depth=bit_depth,
                             row_offset=row_offset, decode_only=decode_only)
    with obs.span("k1.launch"):
        return launch_fused_scan(frames, params)


def fused_decode_triangulate_hdr(
    stacks, cam: Camera, proj: Camera, cfg: PatternConfig, dec: DecodeConfig,
    saturation: float = 0.98, z_bounds=(1.0, 1e4), undistort_iters: int = 8,
    bit_depth: Optional[int] = None, row_offset: float = 0.0,
    fuse: str = "sum",
) -> FusedScanOut:
    """Exposure-bracketed one-pass reconstruction (K2) of (E, F, H, W)
    stacks. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (counted as ``launches.k2``)."""
    _check_hdr_contract(stacks, cfg, fuse)
    if stacks.device.type == "cpu":
        return fused_decode_triangulate_hdr_reference(
            stacks, cam, proj, cfg, dec, saturation, z_bounds,
            undistort_iters, bit_depth, row_offset, fuse)
    E, _, H, W = stacks.shape
    with obs.span("k2.params"):
        params = scan_params(cam, proj, cfg, dec, z_bounds, undistort_iters, H, W,
                             dtype=stacks.dtype, bit_depth=bit_depth,
                             row_offset=row_offset, exposures=E,
                             saturation=saturation, fuse=fuse)
    with obs.span("k2.launch"):
        return launch_fused_scan_hdr(stacks, params)

