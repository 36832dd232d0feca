"""K7's share of its roofline in the two-camera merge: the least time of
a scan's four crossing passes (each camera's pass 1 over its rows into
proj_w bins and pass 2 over the projector columns into proj_h bins; the
frozen byte count with every input read once, over the data sheet's HBM
bandwidth) over the device time of the K7 launches a scan in the traced
slice.

The count reads every carried channel at every camera pixel (48.5 + 37.7
MB a camera, 0.0515 ms a scan). The kernel reads a pixel's channels only
where its pair crosses a bin: on this scene chip_smoke.py counts 36.9 +
31.3 MB a camera (0.0407 ms a scan), so the share read here is about 1.27
times the share of what the data needs (50.5 % against about 40 %).
Reads: slr_torch/kernels/csrc/crossing.cu (interp_fused_kernel),
slr_torch/pipeline/twocam.py::invert_to_projector.
"""

from portbench.frozen import arith


def read(r):
    if r.trace is None or not r.trace.items:
        return None
    t = sum(op.end - op.start for op in r.trace.device if "interp_fused_kernel" in op.name)
    if t <= 0:
        return None
    H, W = r.cfg["camera"]["height"], r.cfg["camera"]["width"]
    pw, ph = r.cfg["projector"]["width"], r.cfg["projector"]["height"]
    cameras = r.cfg["camera"].get("count", 1)
    least = cameras * (arith.bound_s(arith.k7_bytes(H, W, pw))
                       + arith.bound_s(arith.k7_bytes(pw, H, ph)))
    return least / (t / r.trace.items) * 100.0
