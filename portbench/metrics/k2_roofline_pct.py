"""K2's share of its roofline: the least time of one bracket (the frozen
byte count at the configuration's shapes over the data sheet's HBM
bandwidth: the white, black and phase frames of every exposure, the Gray
frames of one, 7 float32 planes written; 60 B a pixel, 78.6 MB, 0.0235 ms
for 3 exposures of config 3) over the mean device time of the traced
slice's K2 launches (``fused_scan_hdr_kernel``, one a bracket).
Reads: slr_torch/kernels/csrc/fused_scan.cu (fused_scan_hdr_kernel).
"""

from portbench.frozen import arith, hdr


def read(r):
    if r.trace is None or "hdr" not in r.cfg:
        return None
    times = [op.end - op.start for op in r.trace.device if "fused_scan_hdr_kernel" in op.name]
    if not times:
        return None
    cam, pat = r.cfg["camera"], r.cfg["pattern"]
    least = arith.bound_s(hdr.k2_bytes(cam["height"], cam["width"], r.cfg["hdr"]["exposures"],
                                       pat["phase_steps"], pat["gray_bits"]))
    return least / (sum(times) / len(times)) * 100.0
