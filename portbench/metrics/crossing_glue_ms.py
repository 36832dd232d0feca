"""Host time of the crossing passes' glue a merge: the median, over the
scans before the traced slice's profiled passes, of the summed host ms of
the program's ``crossing.pairs`` (the pairs and their payload built) and
``crossing.unpack`` (the bin sums turned into the interpolated channels)
spans, the tiled route's work around K6's launches. None where the merge
records neither (the fused route, or a program without those spans).
Reads: slr_torch/kernels/crossing.py (crossing_interp, crossing_pairs,
build_payload).
"""

from portbench import spans


def read(r):
    items = [s for s in spans.scans(r) if spans.has(s, "crossing.pairs")]
    return spans.median(items, lambda s: spans.ms(s, "crossing.pairs")
                        + spans.ms(s, "crossing.unpack"))
