"""Named spans on the served path, recorded as ``torch.profiler`` events.

``span(name)`` records ``name`` while a profiler runs, so the span lands in
the profiler's trace beside the card's kernels and copies, on the trace's
one clock; with no profiler running it is one shared
``contextlib.nullcontext()``, which costs a check of the profiler's flag
(0.39 us an enter and exit, against 7.96 us for an idle
``record_function``; NVIDIA H100 80GB HBM3's host, torch 2.11).  The
recorder is torch's ``_RecordFunctionFast``, a C++ ``RecordFunction``
that the trace lists like an op, not ``record_function``: under a
profiler tracing the card, ``record_function`` dispatches an op of its
own at each edge, ~30-70 us apiece inside an eager prefill, so the card
idled at each of a prefill's 48 block edges while the host sat in no
recorded event.  A span's name is a fixed string, never a request's id,
so a trace's buckets stay few; ``SPANS`` lists every name the program
records.

    with span("model.prefill"):
        logits, cache = model.prefill(...)
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["SPANS", "span"]

SPANS = (
    "scheduler.step",       # RequestScheduler._launch_step: a graph replay or the eager step
    "scheduler.admit",      # RequestScheduler._admit, all of it
    "scheduler.retire",     # RequestScheduler._retire, all of it
    "scheduler.sync",       # a scheduler copy to the card that waits for the card
    "model.prefill",        # the admitted prompt's prefill
    "model.prefill.attn",   # a block's attention half in prefill, its K/V write included
    "model.prefill.ffn",    # a block's feed-forward half in prefill
    "kv_pool.admit",        # KVBlockPool.admit: pages allocated, the prefill's K/V paged in
    "kv_pool.sync",         # a pool copy to the card that waits for the card
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` while a profiler runs, else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
