"""Host-to-card copies that wait for the card (``scheduler.sync`` and
``kv_pool.sync``, a span around each such copy of admission and
retirement): their host ms summed over the traced slice, a slice step.
Most of it is the wait for the step launched just before.  The spans are
the program's own ``torch.profiler`` events (``repro_torch/core/spans.py``);
where the program records no ``scheduler.step`` span, the metric reads
nothing, and a slice that made no such copy reads 0."""

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
    ns = sum(e - s for s, e, n in host if n in SYNCS)
    return ns / 1e6 / slice_steps(rec)
