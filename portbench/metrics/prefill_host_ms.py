"""The admitted prompt's B 1 eager prefill (``model.prefill``, the span
around ``RequestScheduler._admit``'s call of the model's prefill): the
mean host ms of its spans in the traced slice.  The spans are the
program's own ``torch.profiler`` events (``repro_torch/core/spans.py``);
where the program records none, the metric reads nothing."""

SPAN = "model.prefill"
SPANS = (SPAN,)


def read(rec):
    if rec.trace is None:
        return None
    ns = [e - s for s, e, n in rec.trace.host if n == SPAN]
    return sum(ns) / len(ns) / 1e6 if ns else None
