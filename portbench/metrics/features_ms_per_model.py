"""The feature race's coarse alignment a fused model: the median, over the
models before the traced slice's profiled passes, of the program's
``features.*`` spans (FPFH, matching, the hypothesis draws, the RANSAC fits).
Reads: slr_torch/pipeline/registerfuse.py::_batched_feature_race.
"""

from portbench import spans


def read(r):
    return spans.median(spans.models(r), lambda s: spans.ms(s, "features."))
