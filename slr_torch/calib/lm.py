"""Generic Levenberg-Marquardt solver (port of ``slr/calib/lm.py``).

Shared by camera, projector and stereo calibration. The Jacobian comes from
one ``torch.func.jacfwd`` call a step over all parameters, so any residual
written without in-place writes works. The normal equations are damped
multiplicatively and solved in float32 by ``torch.linalg.solve_ex``, which
checks nothing on the host.

The reference's ``while_loop`` stops early once a step improves the cost by
a relative ``tol`` or less. Here the loop runs ``iters`` steps and reads
nothing on the host: every update of x, the cost and lambda is masked by
``active = ~done``, so once ``done`` is set the state freezes, which is
exactly what the early exit returns. ``lm_solve.steps`` holds the last
solve's count of active steps, a device tensor.

On the card the step is launched once eagerly, captured once into a CUDA
graph over static state tensors, and the graph is replayed for the other
steps: the same kernels in the same order as the eager loop, without its
host time (the eager ``jacfwd`` of a step is hundreds of small launches;
``chip_smoke.py``'s 24-view stereo solve took 2.1 s eager and 0.21-0.29 s
replayed on an H100, PERF.md).
"""

from __future__ import annotations

from typing import Callable

import torch


def lm_solve(
    residual_fn: Callable,
    x0: torch.Tensor,
    args=(),
    iters: int = 50,
    lam0: float = 1e-3,
    lam_up: float = 10.0,
    lam_down: float = 0.1,
    tol: float = 1e-12,
):
    """Minimize ||residual_fn(x, *args)||^2 over x.

    Returns (x_opt, final_cost)."""
    def f(x):
        return residual_fn(x, *args)

    def cost_of(x):
        r = f(x)
        return torch.sum(r * r)

    jac = torch.func.jacfwd(f)

    def step(state):
        x, cost, lam, done, steps = state
        active = ~done
        r = f(x)
        J = jac(x)
        JtJ = J.T @ J
        g = J.T @ r
        # multiplicative (Marquardt) damping scales with the diagonal
        damp = lam * torch.diag(torch.diagonal(JtJ) + 1e-12)
        dx, _ = torch.linalg.solve_ex(JtJ + damp, -g)
        x_new = x + dx
        c_new = cost_of(x_new)
        improved = c_new < cost
        c_next = torch.where(improved, c_new, cost)
        lam_next = torch.clamp(torch.where(improved, lam * lam_down, lam * lam_up),
                               1e-12, 1e8)
        rel = torch.abs(cost - c_next) / (cost + 1e-30)
        take = active & improved
        return (torch.where(take, x_new, x), torch.where(active, c_next, cost),
                torch.where(active, lam_next, lam), done | (take & (rel < tol)),
                steps + active.to(torch.int32))

    dev = x0.device
    state = (x0, cost_of(x0), torch.full((), lam0, dtype=x0.dtype, device=dev),
             torch.zeros((), dtype=torch.bool, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev))
    if dev.type == "cuda" and iters > 1:
        state = _replayed(step, state, iters)
    else:
        for _ in range(iters):
            state = step(state)
    lm_solve.steps = state[4]
    return state[0], state[1]


def _replayed(step, state, iters: int):
    """``iters`` steps on the card: the first eager on a side stream (which
    also readies the libraries' handles and workspaces there), then one
    captured on that stream into a CUDA graph that writes the next state
    over static state tensors, replayed ``iters - 1`` times on the current
    stream. No host synchronisation."""
    current = torch.cuda.current_stream(state[0].device)
    side = torch.cuda.Stream(state[0].device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        first = step(state)
    current.wait_stream(side)
    static = [t.clone() for t in first]
    side.wait_stream(current)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        for dst, src in zip(static, step(static)):
            dst.copy_(src)
        graph.capture_end()
    current.wait_stream(side)
    for _ in range(iters - 1):
        graph.replay()
    return static


lm_solve.steps = None
