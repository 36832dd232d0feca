"""ICP a fused model: the median, over the models before the traced
slice's profiled passes, of the program's ``icp`` and ``icp.polish`` spans,
every registration round's and the feature race's.
Reads: slr_torch/pipeline/registerfuse.py::_batched_fine.
"""

from portbench import spans


def read(r):
    return spans.median(spans.models(r),
                        lambda s: spans.ms(s, "icp") + spans.ms(s, "icp.polish"))
