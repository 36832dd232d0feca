"""The end-to-end arithmetic of a window: every item and all the time."""

from __future__ import annotations

import statistics


def rate_per_s(items: int, t0: float, t_end: float) -> float:
    """Items completed over the whole window, from its start to the end of
    its last item."""
    return items / (t_end - t0)


def p95(values) -> float:
    """The 95th percentile of all values (linear between order statistics,
    Python's ``inclusive`` method)."""
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def ms_per_item(items: int, t0: float, t_end: float) -> float:
    """The window, extended to the end of its last item, over its items."""
    return (t_end - t0) / items * 1e3
