"""Host time of a scan's call: the median, over the scans before the
traced slice's profiled passes, of the program's ``scan`` span (its host
interval; the card's work is not waited for at its end).
Reads: slr_torch/pipeline/reconstruct.py::reconstruct_dense.
"""

from portbench import spans


def read(r):
    return spans.median(spans.scans(r), lambda s: spans.ms(s, "scan"))
