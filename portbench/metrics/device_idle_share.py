"""Share (%) of the traced slice in which no kernel, copy or set ran on
the card."""

from pbcore import trace


def read(rec):
    if rec.trace is None:
        return None
    lo, hi = rec.trace.window_ns
    return 100.0 * (1.0 - trace.busy_ns(rec.trace) / (hi - lo))
