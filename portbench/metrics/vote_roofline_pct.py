"""The voting repair's share of its roofline: the least time of one scan's
repair (the larger of its frozen bytes over HBM bandwidth and its 30
instructions a pixel and sweep over the fp32 issue rate) over the device
time of whichever voting kernel the route took (K3 or K4), a scan.
Reads: slr_torch/kernels/csrc/unwrap.cu (vote_resident_kernel, vote_tiled_kernel).
"""

from portbench.frozen import arith


def read(r):
    sweeps = r.params.get("spatial_iters", 0)
    if r.trace is None or not r.trace.items or not sweeps:
        return None
    t = sum(op.end - op.start for op in r.trace.device
            if "vote_resident_kernel" in op.name or "vote_tiled_kernel" in op.name)
    if t <= 0:
        return None
    H, W = r.cfg["camera"]["height"], r.cfg["camera"]["width"]
    least = arith.bound_s(arith.vote_bytes(H, W), arith.vote_instr(H, W, sweeps))
    return least / (t / r.trace.items) * 100.0
