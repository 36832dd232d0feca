"""Device operations a fused model: every kernel, copy and memset the
traced slice put on the card, over its models.
Reads: every stage of the fusion job.
"""


def read(r):
    if r.trace is None or not r.trace.items or not r.trace.device:
        return None
    return len(r.trace.device) / r.trace.items
