"""Host -> card copy time a scan: the device time of the traced slice's
HtoD copies (the frame stacks the stream sends from pinned memory), over
its scans.
Reads: slr_torch/pipeline/stream.py.
"""


def read(r):
    if r.trace is None or not r.trace.items:
        return None
    t = sum(op.end - op.start for op in r.trace.device if "HtoD" in op.name)
    return t / r.trace.items * 1e3 if t > 0 else None
