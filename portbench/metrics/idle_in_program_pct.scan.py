"""The share of the device's idle time in which the host was in the
program's own work: over the idle gaps of the traced slice's host-traced
pass (the breakdown's), the time a program span was open and no ``wait``
among the open ones, over all of that idle time.
Reads: every span of the program.
"""

from portbench import spans


def read(r):
    return spans.idle_in_program_pct(r)
