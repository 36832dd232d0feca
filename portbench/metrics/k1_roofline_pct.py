"""K1's share of its roofline: the least time of one call (the frozen byte
count at the configuration's shapes over the data sheet's HBM bandwidth;
K1 is bound by bytes) over the mean device time of its launches in the
traced slice.

In ``merge_twocam_u8`` every such launch is the decode-only build
(``fused_scan_kernel<unsigned char, 2, false>``, two a scan): 36 frames and
the same seven planes, 64 B a pixel, 0.0250 ms. That build writes its three
point planes as zeros, which the merge never reads; without them the
function needs 52 B a pixel (0.0203 ms), so the share read there is 64/52
of the share of what the function needs (62.8 % against about 51 %).
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
