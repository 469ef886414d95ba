"""Percentiles, frozen: the arithmetic of every tail the benchmark reports."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    closest ranks of the sorted values (numpy's default, "linear"); None
    for no values."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile {q} outside [0, 100]")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

