"""What several metrics' readers share."""

from __future__ import annotations


def slice_steps(rec) -> int:
    """Steps in the traced slice."""
    k0, k1 = rec.slice_steps
    return k1 - k0
