"""Host time of the repair's glue a scan: the median, over the scans before
the traced slice's profiled passes, of the program's ``repair`` span less
its ``repair.vote`` (the phase conversions and the re-triangulation).
Reads: slr_torch/pipeline/reconstruct.py (reconstruct_dense, spatial_repair).
"""

from portbench import spans


def read(r):
    items = [s for s in spans.scans(r) if spans.has(s, "repair")]
    return spans.median(items, lambda s: spans.ms(s, "repair") - spans.ms(s, "repair.vote"))
