"""K1's share of its roofline: the least time of one call (the frozen byte
count at the configuration's shapes over the data sheet's HBM bandwidth;
K1 is bound by bytes) over the mean device time of its launches in the
traced slice.
Reads: slr_torch/kernels/csrc/fused_scan.cu (fused_scan_kernel).
"""

from portbench.frozen import arith


def read(r):
    if r.trace is None:
        return None
    times = [op.end - op.start for op in r.trace.device
             if "fused_scan_kernel" in op.name and "hdr" not in op.name]
    if not times:
        return None
    cam, pat = r.cfg["camera"], r.cfg["pattern"]
    frame_bytes = {"uint8": 1, "uint16": 2, "float32": 4}[r.cfg["frame_dtype"]]
    least = arith.bound_s(arith.k1_bytes(cam["height"], cam["width"], pat["frames"], frame_bytes))
    return least / (sum(times) / len(times)) * 100.0
