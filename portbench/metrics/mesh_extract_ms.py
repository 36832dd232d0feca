"""Mesh extraction a fused model: the median, over the models before the
traced slice's profiled passes, of the program's ``mesh.extract`` span
(its count read and mask index) and the OBJ writer's ``mesh.read`` waits
(the text's length and the text).
Reads: slr_torch/pipeline/tsdf.py (extract_mesh, write_tsdf_mesh_obj).
"""

from portbench import spans


def read(r):
    return spans.median(spans.models(r),
                        lambda s: spans.ms(s, "mesh.extract") + spans.ms(s, "mesh.read"))
