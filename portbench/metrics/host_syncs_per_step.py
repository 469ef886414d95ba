"""Host-to-card copies that wait for the card (``scheduler.sync`` and
``kv_pool.sync``, a span around each such copy of admission and
retirement): how many the traced slice made, a slice step.  The spans
are the program's own ``torch.profiler`` events
(``repro_torch/core/spans.py``); where the program records no
``scheduler.step`` span, the metric reads nothing, and a slice that made
no such copy reads 0."""

from pbcore.readers import slice_steps

STEP = "scheduler.step"
SYNCS = ("scheduler.sync", "kv_pool.sync")
SPANS = (STEP,) + SYNCS


def read(rec):
    if rec.trace is None:
        return None
    host = rec.trace.host
    if not any(n == STEP for _, _, n in host):
        return None
    return sum(1 for _, _, n in host if n in SYNCS) / slice_steps(rec)
