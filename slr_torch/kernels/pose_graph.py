"""The pose graph's Gauss-Newton solve in one launch on the card
(``csrc/pose_graph.cu``).

``slr_torch.registration.posegraph.pose_graph_optimize`` takes it for every
graph on the card: every iteration, the Jacobian in dual numbers, the
normal equations, their LDL^T factor and both triangular solves, and the
updates, in one block of one launch, with no host read. The block works in
shared memory where its ``words`` fit (``in_shared``), else on a workspace
in global memory. The kernel is float32, as the configurations state;
other dtypes on the card are refused. Its plain version is that function's
own loop (``jacfwd``), which CPU tensors keep. The recorder's counter
``launches.pose_graph`` (``slr_torch.observability``) counts the launches:
one a solve. The kernel replaces no TPU kernel: the JAX package solves its
pose graph in plain JAX.
"""

from __future__ import annotations

import ctypes

import torch

from slr_torch.kernels.build import bind, expect, launch

SMEM_MAX = 232_432        # a block's opt-in shared memory on an H100, less 16 B static
MAX_POSES = 1024          # the kernel's int32 offsets into (6S + 1)^2 floats
MAX_EDGES = 1 << 20


def words(S: int, E: int) -> int:
    """The block's working memory on S poses and E edges, in 4-byte words:
    H with the right-hand side as one more row, 1 / D of its LDL^T, the
    poses, 95 words an edge, and where each of H's S (S + 1) / 2 blocks
    starts its list of edges."""
    n = 6 * S
    return (n + 1) ** 2 + n + 12 * S + 95 * E + S * (S + 1) // 2 + 1


def in_shared(S: int, E: int) -> bool:
    """Whether a graph of S poses and E edges works in shared memory (else
    on a workspace in global memory)."""
    return 4 * words(S, E) <= SMEM_MAX


def check_shape(S: int, E: int) -> None:
    """Raise ``ValueError`` unless the kernel takes S poses and E edges."""
    if not (1 <= S <= MAX_POSES and 1 <= E <= MAX_EDGES):
        raise ValueError(f"pose_graph: {S} poses and {E} edges; the kernel takes 1 to "
                         f"{MAX_POSES} poses and 1 to {MAX_EDGES} edges")


_ptr, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
library = bind("pose_graph", {
    "slr_pose_graph": (_i32, [_ptr] * 6 + [_i32] * 3 + [_f32] * 2 + [_ptr] * 4
                       + [ctypes.c_longlong, _ptr, _i32, _ptr]),
})


def solve(R_init, t_init, edges_i, edges_j, Z_R, Z_t, iters: int, damping: float,
          rot_scale: float):
    """``iters`` Gauss-Newton iterations from (R_init, t_init) in one launch:
    (R (S, 3, 3), t (S, 3), cost, rms) on the card, float32, nothing read
    back. Edges (int64 indices) outside [0, S) make every output NaN."""
    S, E = R_init.shape[0], edges_i.shape[0]
    ins = [x.contiguous() for x in (R_init, t_init, edges_i, edges_j, Z_R, Z_t)]
    R0, t0, ei, ej, ZR, Zt = ins
    f32, i64 = torch.float32, torch.int64
    expect("pose_graph", (R0, (S, 3, 3), f32), (t0, (S, 3), f32), (ei, (E,), i64),
           (ej, (E,), i64), (ZR, (E, 3, 3), f32), (Zt, (E, 3), f32))
    check_shape(S, E)
    R = torch.empty_like(R0)
    t = torch.empty_like(t0)
    cost_rms = torch.empty(2, dtype=torch.float32, device=R.device)
    if in_shared(S, E):
        smem, ws = 4 * words(S, E), None
    else:
        smem, ws = 0, torch.empty(words(S, E), dtype=torch.float32, device=R.device)
    launch(library(), "slr_pose_graph", "pose-graph", R.device,
           *(x.data_ptr() for x in ins), S, E, max(int(iters), 0), float(damping),
           float(rot_scale), R.data_ptr(), t.data_ptr(), cost_rms.data_ptr(),
           cost_rms[1:].data_ptr(), smem, None if ws is None else ws.data_ptr(),
           counter="launches.pose_graph")
    return R, t, cost_rms[0], cost_rms[1]
