"""Voxel fuse time a fused model: the mean over the traced run's window of the benchmark's span
around the call (its host wall, ending in a card sync).
Reads: slr_torch/pipeline/registerfuse.py::fuse_scans.
"""


def read(r):
    t = r.spans.get("fuse")
    return sum(t) / len(t) * 1e3 if t else None
