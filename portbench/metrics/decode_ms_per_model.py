"""Decode time a fused model, all its scans: the mean over the traced run's window of the benchmark's span
around the call (its host wall, ending in a card sync).
Reads: slr_torch/dist/batch.py::batched_reconstruct.
"""


def read(r):
    t = r.spans.get("decode")
    return sum(t) / len(t) * 1e3 if t else None
