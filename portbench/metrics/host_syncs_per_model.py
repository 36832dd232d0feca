"""Host syncs a fused model: the median, over the models before the traced
slice's profiled passes, of the syncs of the program's ``wait`` spans in a
model (a wait marks one call, which may sync more than once).
Reads: every call of the fusion job that makes the host wait for the card.
"""

from portbench import spans


def read(r):
    return spans.median(spans.models(r), spans.syncs)
