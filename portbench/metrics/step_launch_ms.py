"""The scheduler step's launch (``scheduler.step``, the span around
``RequestScheduler._launch_step``: the CUDA graph's replay): the mean host
ms of its spans in the traced slice.  The spans are the program's own
``torch.profiler`` events (``repro_torch/core/spans.py``); where the
program records none, the metric reads nothing."""

SPAN = "scheduler.step"
SPANS = (SPAN,)


def read(rec):
    if rec.trace is None:
        return None
    ns = [e - s for s, e, n in rec.trace.host if n == SPAN]
    return sum(ns) / len(ns) / 1e6 if ns else None
