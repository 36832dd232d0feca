"""The crossing passes' share of their roofline in the two-camera merge:
the least time of a scan's four crossing passes over the device time of
the crossing kernels a scan in the traced slice, whichever route the
program takes: ``bin_sum_kernel`` (K6, the tiled route, after the pairs
and their payload were built by other launches) or ``interp_fused_kernel``
(K7, one launch a pass).

The least time counts the passes' own work and not any route's
intermediates: each camera's pass 1 over its rows into proj_w bins and
pass 2 over the projector columns into proj_h bins, with every input read
once (``arith.k7_bytes``), over the data sheet's HBM bandwidth; at
2448x2048 with a 1024x768 projector 147.2 + 59.8 MB a camera, 414.0 MB
and 0.1236 ms a scan. So a change of the route rule reads the same work.
K6's own every-input count is larger (its payload: pass 1 239.1 MB at 5
MP), so the share read here on the tiled route is below K6's share of
its own bound.
Reads: slr_torch/kernels/csrc/crossing.cu (bin_sum_kernel,
interp_fused_kernel), slr_torch/pipeline/twocam.py::invert_to_projector.
"""

from portbench.frozen import arith

KERNELS = ("bin_sum_kernel", "interp_fused_kernel")


def read(r):
    if r.trace is None or not r.trace.items:
        return None
    t = sum(op.end - op.start for op in r.trace.device
            if any(k in op.name for k in KERNELS))
    if t <= 0:
        return None
    H, W = r.cfg["camera"]["height"], r.cfg["camera"]["width"]
    pw, ph = r.cfg["projector"]["width"], r.cfg["projector"]["height"]
    cameras = r.cfg["camera"].get("count", 1)
    least = cameras * arith.bound_s(arith.k7_bytes(H, W, pw) + arith.k7_bytes(pw, H, ph))
    return least / (t / r.trace.items) * 100.0
