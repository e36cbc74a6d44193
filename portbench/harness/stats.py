"""The spread of a metric over runs."""

from __future__ import annotations

import statistics


def spread(xs) -> float:
    """Distance between the first and third quartiles (Python's
    statistics.quantiles, n=4) over the median."""
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return (q3 - q1) / q2
