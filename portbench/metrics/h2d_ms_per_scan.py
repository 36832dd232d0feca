"""Host -> card copy time a scan: the device time of the traced slice's
HtoD copies (the frame stacks the stream sends from pinned memory), over
its scans. In ``merge_twocam_u8`` the copies are the generator's: both
cameras' stacks from pinned memory, in line before each merge (the
program has no two-camera stream).
Reads: slr_torch/pipeline/stream.py; the twocam_stream generator.
"""


def read(r):
    if r.trace is None or not r.trace.items:
        return None
    t = sum(op.end - op.start for op in r.trace.device if "HtoD" in op.name)
    return t / r.trace.items * 1e3 if t > 0 else None
