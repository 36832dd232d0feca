"""The share of the slice's unprofiled wall in which nothing ran on the
card: the union of kernel, copy and memset intervals (overlaps counted
once) of its device-traced repeat.
Reads: the card, over the whole scan path.
"""

from portbench import tracing


def read(r):
    if r.trace is None:
        return None
    idle = tracing.idle_share(r.trace)
    return None if idle is None else idle * 100.0
