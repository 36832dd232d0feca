"""Bundle adjustment time a fused model: the mean over the traced run's window of the benchmark's span
around the call (its host wall, ending in a card sync).
Reads: slr_torch/pipeline/registerfuse.py::ba_refine -> slr_torch/dist/ba.py.
"""


def read(r):
    t = r.spans.get("ba")
    return sum(t) / len(t) * 1e3 if t else None
