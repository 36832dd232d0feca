"""Host syncs a scan: the median, over the scans before the traced slice's
profiled passes, of the syncs of the program's ``wait`` spans in a scan's
request (a wait marks one call, which may sync more than once).
Reads: every call of the scan path that makes the host wait for the card.
"""

from portbench import spans


def read(r):
    return spans.median(spans.scans(r), spans.syncs)
