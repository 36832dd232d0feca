"""Pose-graph refinement a fused model: the median, over the models before
the traced slice's profiled passes, of the program's ``pose_graph`` span.
Reads: slr_torch/pipeline/registerfuse.py -> slr_torch/registration/posegraph.py.
"""

from portbench import spans


def read(r):
    return spans.median(spans.models(r), lambda s: spans.ms(s, "pose_graph"))
