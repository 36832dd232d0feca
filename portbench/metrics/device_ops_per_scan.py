"""Device operations a scan: every kernel, copy and memset the traced
slice put on the card, over its scans (an exact count).
Reads: slr_torch/pipeline/reconstruct.py, slr_torch/kernels/fused_scan.py.
"""


def read(r):
    if r.trace is None or not r.trace.items or not r.trace.device:
        return None
    return len(r.trace.device) / r.trace.items
