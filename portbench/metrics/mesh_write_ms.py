"""Mesh extraction and OBJ write time a fused model: the mean over the traced run's window of the benchmark's span
around the call (its host wall, ending in a card sync).
Reads: slr_torch/pipeline/tsdf.py::write_tsdf_mesh_obj.
"""


def read(r):
    t = r.spans.get("mesh_write")
    return sum(t) / len(t) * 1e3 if t else None
