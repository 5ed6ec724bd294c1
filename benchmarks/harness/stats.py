"""The yardstick's arithmetic: rates over a whole window, percentiles over
every request, and rooflines against the card's published bandwidth."""

from __future__ import annotations

import math
from typing import Sequence

# NVIDIA H100 SXM's HBM3, the data sheet's figure at its 700 W limit.
PEAK_HBM_BYTES_PER_S = 3.35e12


def rate(count: float, seconds: float) -> float:
    """Work done over the whole window's elapsed time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0–100) of ``values``, every one of them,
    linear between the order statistics (numpy's default method)."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def bytes_bound_s(nbytes: float) -> float:
    """The least time in which the card moves ``nbytes`` through HBM."""
    return nbytes / PEAK_HBM_BYTES_PER_S


def roofline_share(bound_s: float, measured_s: float) -> float:
    """The bound's share of the measured time, in %."""
    return 100.0 * bound_s / measured_s
