"""Host time a fused model spends waiting for the card: the median, over
the models before the traced slice's profiled passes, of the program's
``wait`` spans in a model.
Reads: every call of the fusion job that makes the host wait for the card.
"""

from portbench import spans


def read(r):
    return spans.median(spans.models(r), lambda s: spans.ms(s, waits=True))
