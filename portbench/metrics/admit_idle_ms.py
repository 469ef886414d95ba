"""Admission and retirement (``scheduler.admit`` and ``scheduler.retire``,
the spans around ``RequestScheduler._admit`` and ``_retire``): the ms of
the union of their spans in the traced slice during which no kernel, copy
or set ran on the card, over the slice's admissions.  Host spans and
device events share the profiler's clock.  The spans are the program's
own ``torch.profiler`` events (``repro_torch/core/spans.py``); where the
program records no admission in the slice, the metric reads nothing."""

from pbcore import trace

ADMIT, RETIRE = "scheduler.admit", "scheduler.retire"
SPANS = (ADMIT, RETIRE)


def _overlap_ns(a, b) -> int:
    """ns that two sorted lists of disjoint intervals share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(rec):
    if rec.trace is None:
        return None
    held = [h for h in rec.trace.host if h[2] in SPANS]
    admissions = sum(1 for _, _, n in held if n == ADMIT)
    if not admissions:
        return None
    spans = trace.union(held)
    idle = (sum(e - s for s, e in spans)
            - _overlap_ns(spans, trace.union(rec.trace.device)))
    return idle / 1e6 / admissions
