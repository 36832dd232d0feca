"""Fused decode -> unwrap -> triangulate: the config-3 hot path.

Port of ``slr/kernels/fused_scan.py::fused_decode_triangulate``. The
(F, H, W) captured stack is read once and the kernel writes the 3-D point
map, validity mask, quality, ``x_p`` and ``y_p`` directly: Gray decode
with per-bit certainty, N-step phase, cyclic half-shifted temporal unwrap,
camera-ray undistortion and ray x projector-column-plane triangulation.

``fused_decode_triangulate`` is the wrapper. A CPU tensor takes the plain
PyTorch version, ``fused_decode_triangulate_reference``; a CUDA tensor
launches the hand-written kernel ``csrc/fused_scan.cu`` or raises.

Contract (both routes): gray_phase coding with inverse patterns,
phase_steps > 0, column-only coding (row_gray_bits = 0), float32 frames,
and the camera at the world origin (R = I, t = 0). The uint8/uint16,
Gray-only, row+column midpoint, multifreq and ``decode_only`` branches of
the reference kernel are ROADMAP slice 2.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from slr_torch.codec.graycode import gray_decode_int
from slr_torch.config import DecodeConfig, PatternConfig
from slr_torch.geom.camera import Camera, undistort_iterative
from slr_torch.kernels.build import load_library

TWO_PI = 2.0 * math.pi
MAX_STEPS = 32  # SLR_MAX_STEPS in csrc/fused_scan.cu


class FusedScanOut(NamedTuple):
    points: torch.Tensor   # (3, H, W) world-frame points (0 where invalid)
    mask: torch.Tensor     # (H, W) f32 0/1 validity
    quality: torch.Tensor  # (H, W) phase modulation B
    x_p: torch.Tensor      # (H, W) decoded sub-pixel projector column
    y_p: torch.Tensor      # (H, W) decoded projector row (0: not coded)


class _ScanParams(ctypes.Structure):
    """Mirror of ``SlrScanParams`` in csrc/fused_scan.cu."""

    _fields_ = [(name, ctypes.c_int32) for name in
                ("height", "width", "bits", "steps", "undistort_iters")] + [
        (name, ctypes.c_float) for name in
        ("tau_black", "tau_white", "tau_mod", "mod_scale", "xp_scale",
         "w_coded", "w_fold", "zmin", "zmax", "fx", "fy", "cx", "cy",
         "k1", "k2", "p1", "p2", "k3", "pfx", "pcx")] + [
        ("R", ctypes.c_float * 9), ("C", ctypes.c_float * 3),
        ("sin_d", ctypes.c_float * MAX_STEPS),
        ("cos_d", ctypes.c_float * MAX_STEPS)]


def _check_contract(frames, cfg: PatternConfig):
    if (cfg.coding != "gray_phase" or not cfg.use_inverse
            or cfg.phase_steps <= 0 or cfg.row_gray_bits):
        raise NotImplementedError(
            "the fused scan is ported for gray_phase coding with inverse "
            "patterns, phase_steps > 0 and row_gray_bits = 0 only; the other "
            "branches are ROADMAP slice 2")
    if frames.dtype != torch.float32:
        raise NotImplementedError(
            f"the fused scan takes float32 frames; {frames.dtype} ingest is "
            "ROADMAP slice 2")
    if cfg.phase_steps > MAX_STEPS:
        raise ValueError(f"at most {MAX_STEPS} phase steps")
    if frames.dim() != 3 or frames.shape[0] != cfg.num_frames:
        raise ValueError(f"frames must be ({cfg.num_frames}, H, W), got "
                         f"{tuple(frames.shape)}")


def _check_camera_at_origin(R, t):
    if not (torch.equal(R, torch.eye(3, dtype=R.dtype, device=R.device))
            and not torch.any(t)):
        raise ValueError("the fused scan needs the camera at the world "
                         "origin (R = I, t = 0)")


def _unwrap_constants(cfg: PatternConfig):
    """Phase weights and unwrap scalars, rounded to float32 once so that
    the kernel and the plain version use the same values."""
    steps = cfg.phase_steps
    deltas = [TWO_PI * k / steps for k in range(steps)]
    pitch = np.float32(cfg.fringe_pitch)
    w_coded = pitch * np.float32(1 << cfg.gray_bits)
    return dict(sin_d=[math.sin(d) for d in deltas],
                cos_d=[math.cos(d) for d in deltas],
                mod_scale=2.0 / steps,
                xp_scale=float(pitch / np.float32(TWO_PI)),
                w_coded=float(w_coded),
                w_fold=float(w_coded - np.float32(0.5)))


def fused_decode_triangulate_reference(
    frames, cam: Camera, proj: Camera, cfg: PatternConfig, dec: DecodeConfig,
    z_bounds=(1.0, 1e4), undistort_iters: int = 8,
) -> FusedScanOut:
    """Plain PyTorch version of the kernel, the same arithmetic in the same
    order, on any device."""
    _check_contract(frames, cfg)
    _check_camera_at_origin(cam.R.cpu(), cam.t.cpu())
    _, H, W = frames.shape
    bits, steps = cfg.gray_bits, cfg.phase_steps
    c = _unwrap_constants(cfg)
    dev = frames.device

    valid = (frames[0] - frames[1]) > dec.black_threshold
    gray = torch.zeros((H, W), dtype=torch.int32, device=dev)
    for i in range(bits):
        diff = frames[2 + i] - frames[2 + bits + i]
        gray = (gray << 1) | (diff > 0.0).to(torch.int32)
        valid = valid & (diff.abs() > dec.white_threshold)
    code = gray_decode_int(gray, bits)

    S = torch.zeros((H, W), device=dev)
    C = torch.zeros((H, W), device=dev)
    for k in range(steps):
        fk = frames[2 + 2 * bits + k]
        S = S + fk * c["sin_d"][k]
        C = C + fk * c["cos_d"][k]
    phi = torch.atan2(S, C)
    phi = torch.where(phi < 0.0, phi + TWO_PI, phi)
    quality = c["mod_scale"] * torch.sqrt(S * S + C * C)
    valid = valid & (quality > dec.modulation_threshold)

    order = code - (phi >= math.pi).to(torch.int32)
    order = torch.where(order < 0, order + (1 << bits), order)
    x_p = (phi + TWO_PI * order.to(torch.float32)) * c["xp_scale"]
    x_p = torch.where(x_p > c["w_fold"], x_p - c["w_coded"], x_p)

    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    xn, yn = undistort_iterative((u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                                 cam.dist, undistort_iters)

    R, Cw = proj.R, proj.center
    xnp = (x_p - proj.cx) / proj.fx
    nwx = R[0, 0] - R[2, 0] * xnp
    nwy = R[0, 1] - R[2, 1] * xnp
    nwz = R[0, 2] - R[2, 2] * xnp
    den = nwx * xn + nwy * yn + nwz
    den = torch.where(den.abs() < 1e-12, 1e-12, den)
    lam = (nwx * Cw[0] + nwy * Cw[1] + nwz * Cw[2]) / den
    valid = valid & (lam > z_bounds[0]) & (lam < z_bounds[1])

    points = torch.where(valid, torch.stack([xn * lam, yn * lam, lam]), 0.0)
    return FusedScanOut(points=points, mask=valid.to(torch.float32),
                        quality=quality, x_p=x_p, y_p=torch.zeros_like(x_p))


def scan_params(cam: Camera, proj: Camera, cfg: PatternConfig,
                dec: DecodeConfig, z_bounds, undistort_iters: int,
                height: int, width: int) -> _ScanParams:
    """The kernel's parameter block, built on the host. The calibration is
    brought to the host in one transfer."""
    fields = [x.reshape(-1).to(torch.float32) for x in (*cam, *proj)]
    flat = torch.cat(fields).cpu().split([f.numel() for f in fields])
    cam_h = Camera(*(x.reshape(s.shape) for x, s in zip(flat[:7], cam)))
    proj_h = Camera(*(x.reshape(s.shape) for x, s in zip(flat[7:], proj)))
    _check_camera_at_origin(cam_h.R, cam_h.t)
    c = _unwrap_constants(cfg)
    p = _ScanParams(
        height=height, width=width, bits=cfg.gray_bits,
        steps=cfg.phase_steps, undistort_iters=undistort_iters,
        tau_black=dec.black_threshold, tau_white=dec.white_threshold,
        tau_mod=dec.modulation_threshold, mod_scale=c["mod_scale"],
        xp_scale=c["xp_scale"], w_coded=c["w_coded"], w_fold=c["w_fold"],
        zmin=z_bounds[0], zmax=z_bounds[1],
        fx=float(cam_h.fx), fy=float(cam_h.fy),
        cx=float(cam_h.cx), cy=float(cam_h.cy),
        pfx=float(proj_h.fx), pcx=float(proj_h.cx),
    )
    p.k1, p.k2, p.p1, p.p2, p.k3 = cam_h.dist.tolist()
    p.R[:] = proj_h.R.reshape(-1).tolist()
    p.C[:] = proj_h.center.tolist()
    p.sin_d[:cfg.phase_steps] = c["sin_d"]
    p.cos_d[:cfg.phase_steps] = c["cos_d"]
    return p


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("fused_scan")
    if lib.slr_fused_scan_params_size() != ctypes.sizeof(_ScanParams):
        raise RuntimeError("SlrScanParams in csrc/fused_scan.cu and "
                           "_ScanParams disagree on their layout")
    lib.slr_fused_scan.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int,
                                                           ctypes.c_void_p]
    lib.slr_fused_scan.restype = ctypes.c_int
    lib.slr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.slr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch_fused_scan(frames, params: _ScanParams) -> FusedScanOut:
    """Launch the CUDA kernel on PyTorch's current stream (no sync)."""
    if frames.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {frames.device}")
    if frames.dtype != torch.float32 or not frames.is_contiguous():
        raise ValueError("frames must be contiguous float32")
    F, H, W = frames.shape
    if (H, W) != (params.height, params.width) or F != (
            2 + 2 * params.bits + params.steps):
        raise ValueError(f"frames {tuple(frames.shape)} do not match the "
                         "parameter block")
    lib = _library()
    out = torch.empty((7, H, W), dtype=torch.float32, device=frames.device)
    err = lib.slr_fused_scan(
        frames.data_ptr(), out[0].data_ptr(), out[3].data_ptr(),
        out[4].data_ptr(), out[5].data_ptr(), out[6].data_ptr(),
        ctypes.addressof(params), frames.device.index,
        torch.cuda.current_stream(frames.device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_scan kernel launch failed: "
                           + lib.slr_cuda_error_string(err).decode())
    fused_decode_triangulate.launches += 1
    return FusedScanOut(points=out[:3], mask=out[3], quality=out[4],
                        x_p=out[5], y_p=out[6])


def fused_decode_triangulate(
    frames, cam: Camera, proj: Camera, cfg: PatternConfig, dec: DecodeConfig,
    z_bounds=(1.0, 1e4), undistort_iters: int = 8,
) -> FusedScanOut:
    """One-pass scan reconstruction. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel (``.launches`` counts the launches)."""
    _check_contract(frames, cfg)
    if frames.device.type == "cpu":
        return fused_decode_triangulate_reference(
            frames, cam, proj, cfg, dec, z_bounds, undistort_iters)
    _, H, W = frames.shape
    return launch_fused_scan(frames, scan_params(
        cam, proj, cfg, dec, z_bounds, undistort_iters, H, W))


fused_decode_triangulate.launches = 0
