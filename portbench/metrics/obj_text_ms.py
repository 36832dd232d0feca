"""The OBJ text a fused model: the median, over the models before the
traced slice's profiled passes, of the program's ``mesh.text`` spans (the
formatter's launches).
Reads: slr_torch/pipeline/tsdf.py::write_tsdf_mesh_obj.
"""

from portbench import spans


def read(r):
    return spans.median(spans.models(r), lambda s: spans.ms(s, "mesh.text"))
