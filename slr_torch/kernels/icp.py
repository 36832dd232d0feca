"""Point-to-plane ICP in one launch on the card (``csrc/icp.cu``): every
iteration of every edge of a round.

Two routes, one launch each, sharing the gate, the Huber weights, the 6x6
normal equations, their solve and the pose update:

- ``align``: each source point's correspondence is its nearest valid target
  point (``registration/icp.py::icp_point_to_plane`` on its exact route);
  counted as ``launches.icp``.
- ``polish``: the correspondence is read off an organized target grid where
  the rig camera sees the moved point (``registration/projective.py::
  icp_projective``); counted as ``launches.icp_polish``.

The route rule is ``takes_kernel``: the NN route takes every call on the
card that resolves to the exact search; the projective route takes every
call on the card. A target past one block's shared memory is staged a chunk
at a time, with the bits of a single staging. Both launches take float32
alone and raise ``ValueError`` on anything else. The plain versions are
``icp_point_to_plane_reference`` and ``icp_projective_reference``, which
CPU tensors keep. Nothing is read on the host. The kernel replaces no TPU
kernel: the JAX package runs its ICP in plain JAX.
"""

from __future__ import annotations

import ctypes

import torch

from slr_torch.kernels.build import bind, expect, launch

SMEM_MAX = 232_448        # a block's opt-in shared memory on an H100
HEAD_BYTES = 1_600        # the block's reductions, pose and camera (SLR_ICP_HEAD_BYTES)
CHUNK = (SMEM_MAX - HEAD_BYTES) // 16   # target points a block stages at once (SLR_ICP_CHUNK)
MAX_POINTS = (2**31 - 1) // 3           # the kernel's int32 offsets
CAM_FLOATS = 21           # R, t, fx, fy, cx, cy and the five distortion terms


def smem_bytes(M: int) -> int:
    """A block's shared memory on the NN route with M target points: its
    head and the staged target (all of it, or a chunk), 16 B a point."""
    return HEAD_BYTES + 16 * min(M, CHUNK)


def takes_kernel(N: int, M: int, device, nn_method: str = "auto") -> bool:
    """Whether an NN-route call of N source and M target points on
    ``device`` takes the kernel: a CUDA device and the exact search
    (``_resolve_nn_method``; "auto": N M <= 24000^2)."""
    from slr_torch.registration.icp import _resolve_nn_method

    return (torch.device(device).type == "cuda"
            and _resolve_nn_method(nn_method, N, M, device) == "exact")


_ptr, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
library = bind("icp", {
    "slr_icp_nn": (_i32, [_ptr] * 7 + [_i32] * 4 + [_f32] + [_ptr] * 6 + [_i32, _ptr]),
    "slr_icp_projective": (_i32, [_ptr] * 9 + [_i32] * 6 + [_f32] + [_ptr] * 5
                           + [_i32, _ptr]),
})


def _batch(what, src, iters):
    """(E, N) of an (E, N, 3) source; raise ``ValueError`` on another rank,
    past MAX_POINTS, or on fewer than one iteration."""
    if src.dim() != 3:
        raise ValueError(f"{what}: the source must be (E, N, 3), got {tuple(src.shape)}")
    if src.shape[1] > MAX_POINTS:
        raise ValueError(f"{what}: {src.shape[1]} source points; at most {MAX_POINTS}")
    if int(iters) < 1:
        raise ValueError(f"{what}: iters must be at least 1, got {iters}")
    return src.shape[0], src.shape[1]


def _optional(x, shape, dtype):
    return [] if x is None else [(x, shape, dtype)]


def _ptr_of(x):
    return None if x is None else x.data_ptr()


def _outputs(E, device):
    f32 = torch.float32
    return (torch.empty((E, 3, 3), dtype=f32, device=device),
            torch.empty((E, 3), dtype=f32, device=device),
            torch.empty(E, dtype=f32, device=device), torch.empty(E, dtype=f32, device=device))


def align(src, tgt, tgt_n, src_valid=None, tgt_valid=None, R0=None, t0=None, iters=20,
          max_corr_dist=10.0):
    """``iters`` NN-route iterations of E edges in one launch: the (E, N, 3)
    sources onto the (E, M, 3) targets with normals; optional (E, N) and
    (E, M) bool masks and (E, 3, 3), (E, 3) inits, all float32 but the
    masks. Returns (R (E, 3, 3), t (E, 3), rms (E,), inlier_frac (E,)) on
    the card, float32."""
    E, N = _batch("icp", src, iters)
    M = tgt.shape[1] if tgt.dim() == 3 else -1
    f32, b = torch.float32, torch.bool
    src, tgt, tgt_n, src_valid, tgt_valid, R0, t0 = (
        None if x is None else x.contiguous()
        for x in (src, tgt, tgt_n, src_valid, tgt_valid, R0, t0))
    expect("icp", (src, (E, N, 3), f32), (tgt, (E, M, 3), f32), (tgt_n, (E, M, 3), f32),
           *_optional(src_valid, (E, N), b), *_optional(tgt_valid, (E, M), b),
           *_optional(R0, (E, 3, 3), f32), *_optional(t0, (E, 3), f32))
    if not 1 <= M <= MAX_POINTS:
        raise ValueError(f"icp: {M} target points; the kernel takes 1 to {MAX_POINTS}")
    R, t, rms, inl = _outputs(E, src.device)
    work = torch.empty((E, N), dtype=torch.int32, device=src.device)
    best = torch.empty((E, N), dtype=f32, device=src.device) if M > CHUNK else None
    launch(library(), "slr_icp_nn", "icp", src.device,
           *map(_ptr_of, (src, src_valid, tgt, tgt_n, tgt_valid, R0, t0)), E, N, M,
           int(iters), float(max_corr_dist) ** 2, work.data_ptr(), _ptr_of(best),
           *(x.data_ptr() for x in (R, t, rms, inl)), counter="launches.icp")
    return R, t, rms, inl


def _camera_vector(cam, device):
    """The rig camera as the kernel reads it: (21,) float32 on ``device``,
    assembled on the card (R, t, fx, fy, cx, cy, dist)."""
    return torch.cat([torch.as_tensor(x).reshape(-1) for x in
                      (cam.R, cam.t, cam.fx, cam.fy, cam.cx, cam.cy, cam.dist)]).to(
        device=device, dtype=torch.float32)


def polish(src, src_valid, grid, grid_mask, grid_n, grid_of, cam, R0=None, t0=None,
           iters=15, max_corr_dist=10.0):
    """``iters`` projective-route iterations of E edges in one launch: the
    (E, N, 3) sources (optional (E, N) bool mask) onto G organized grids
    (points (G, H, W, 3), mask (G, H, W) bool, normals (G, H, W, 3)), edge
    e on grid ``grid_of[e]`` ((E,) int64; None: grid e), seen through the
    rig camera ``cam``. Returns as ``align``."""
    E, N = _batch("icp_polish", src, iters)
    G, H, W = grid_mask.shape if grid_mask.dim() == 3 else (-1, -1, -1)
    f32, b = torch.float32, torch.bool
    src, src_valid, grid, grid_mask, grid_n, grid_of, R0, t0 = (
        None if x is None else x.contiguous()
        for x in (src, src_valid, grid, grid_mask, grid_n, grid_of, R0, t0))
    expect("icp_polish", (src, (E, N, 3), f32), (grid, (G, H, W, 3), f32),
           (grid_mask, (G, H, W), b), (grid_n, (G, H, W, 3), f32),
           *_optional(src_valid, (E, N), b), *_optional(grid_of, (E,), torch.int64),
           *_optional(R0, (E, 3, 3), f32), *_optional(t0, (E, 3), f32))
    if H * W > MAX_POINTS:
        raise ValueError(f"icp_polish: {H} x {W} pixels; at most {MAX_POINTS}")
    if grid_of is None and G != E:
        raise ValueError(f"icp_polish: {E} edges on {G} grids need grid_of")
    cam_v = _camera_vector(cam, src.device)
    expect("icp_polish", (cam_v, (CAM_FLOATS,), f32))
    R, t, rms, inl = _outputs(E, src.device)
    work = torch.empty((E, N), dtype=torch.int32, device=src.device)
    launch(library(), "slr_icp_projective", "icp_polish", src.device,
           *map(_ptr_of, (src, src_valid, grid, grid_mask, grid_n, grid_of, cam_v, R0, t0)),
           E, N, G, H, W, int(iters), float(max_corr_dist) ** 2, work.data_ptr(),
           *(x.data_ptr() for x in (R, t, rms, inl)), counter="launches.icp_polish")
    return R, t, rms, inl
