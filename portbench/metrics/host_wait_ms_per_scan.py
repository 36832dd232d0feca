"""Host time a scan spends waiting for the card: the median, over the scans
before the traced slice's profiled passes, of the program's ``wait`` spans
in a scan's request (K1's parameter read among them).
Reads: slr_torch/kernels/fused_scan.py::scan_params, slr_torch/pipeline/stream.py.
"""

from portbench import spans


def read(r):
    return spans.median(spans.scans(r), lambda s: spans.ms(s, waits=True))
