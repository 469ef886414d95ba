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

The moe layer's four parts (``MOE_SPANS``) record only where the layer
runs eagerly (the CPU, ``graph=False``, ``generate``): a CUDA graph's
replay records no span.

Counters of the routing (``tally``, ``count_routing``, ``counters``) are
kept on the device: a moe prefill or decode step opens a tally, each moe
layer in it hands over its expert ids and its dispatch's kept slots, and
the tally's exit reduces them with a few launches and adds the step's
figures to running totals on the device, per phase.  Nothing is copied to
the host inside a step, so a CUDA graph captures the counting with the
step and every replay counts; ``counters()`` reads the totals, a copy
that waits for the card, after a stream.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["SPANS", "MOE_SPANS", "span", "ROUTING_COUNTERS", "tally",
           "count_routing", "counters", "reset_counters"]

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

# the moe layer's parts (models/moe.py::_routed_experts), on its eager path
MOE_SPANS = (
    "moe.route",            # the router's product, the softmax and the top-k
    "moe.dispatch",         # the capacity tables and the gather of each slot's token
    "moe.experts",          # the routed experts' three products over the dispatch buffer
    "moe.combine",          # each assignment's output, weighted, added in expert order
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` while a profiler runs, else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


# ---------------------------------------------------------------------------
# routing counters
# ---------------------------------------------------------------------------

# the totals a phase keeps, in this order (float64 on the device, exact
# for counts below 2^53)
ROUTING_COUNTERS = (
    "steps",                # tallies closed: prefills or decode steps
    "layer_calls",          # moe layers run
    "assignments",          # (token, expert) pairs routed
    "dropped",              # assignments past an expert's capacity
    "experts_hit",          # experts with one assignment or more, summed over layers
    "load_max_over_mean",   # the most-loaded expert's assignments over the mean, summed over layers
)

_open: Optional["_Tally"] = None
_totals: Dict[Tuple[str, str], torch.Tensor] = {}


class _Tally:
    def __init__(self, phase: str):
        self.phase = phase
        self.items: List[Tuple[torch.Tensor, torch.Tensor, int]] = []

    def close(self) -> None:
        """Add this step's figures to the phase's totals: a few launches
        over every layer's ids at once."""
        if not self.items:
            return
        ids = torch.stack([i for i, _, _ in self.items])      # [L, T, k]
        kept = torch.stack([v for _, v, _ in self.items])     # [L, ...]
        E, dev, f64 = self.items[0][2], ids.device, torch.float64
        key = (self.phase, str(dev))
        if key not in _totals:
            if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
                # a graph would zero them at every replay
                raise RuntimeError(f"the {self.phase} counters must exist "
                                   f"before a graph that counts is captured: "
                                   f"run the phase once eagerly first")
            _totals[key] = torch.zeros(len(ROUTING_COUNTERS), dtype=f64,
                                       device=dev)
        L, A = ids.shape[0], ids[0].numel()
        load = torch.zeros((L, E), dtype=f64, device=dev).scatter_add_(
            1, ids.reshape(L, A).long(), torch.ones((L, A), dtype=f64, device=dev))
        one = torch.ones((), dtype=f64, device=dev)
        _totals[key].add_(torch.stack([
            one, one * L, one * (L * A), L * A - kept.sum(dtype=f64),
            (load > 0).sum(dtype=f64), (load.amax(1) * (E / A)).sum()]))


@contextlib.contextmanager
def tally(phase: str):
    """Count the routing of the moe layers run inside the block under
    ``phase`` (``"moe.prefill"``, ``"moe.decode"``); a tally opened inside
    another counts into the outer one."""
    global _open
    if _open is not None:
        yield
        return
    _open = _Tally(phase)
    try:
        yield
        _open.close()
    finally:
        _open = None


def count_routing(ids: torch.Tensor, kept: torch.Tensor, n_experts: int) -> None:
    """A moe layer's expert ids ``[T, k]`` and its dispatch's slots that
    hold an assignment (a bool tensor, one element a slot), for the tally
    that is open; nothing where none is.  Every layer of one tally routes
    the same tokens, so their tensors stack."""
    if _open is not None:
        _open.items.append((ids, kept, int(n_experts)))


def counters() -> Dict[str, Dict[str, float]]:
    """The totals of each phase on each device, read from the card (a copy
    that waits for it): ``{"moe.decode": {"steps": ..., ...}, ...}``,
    summed over devices."""
    out: Dict[str, Dict[str, float]] = {}
    for (phase, _), t in _totals.items():
        row = out.setdefault(phase, dict.fromkeys(ROUTING_COUNTERS, 0.0))
        for name, v in zip(ROUTING_COUNTERS, t.tolist()):
            row[name] += v
    return out


def reset_counters() -> None:
    """Zero the totals in place (a captured graph keeps adding to them)."""
    for t in _totals.values():
        t.zero_()

