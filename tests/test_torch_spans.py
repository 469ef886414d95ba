"""The served path's spans (``repro_torch.core.spans``) on the CPU.

A short stream of reduced internlm2-1.8b through ``RequestScheduler``
under ``torch.profiler`` (CPU activity): one ``scheduler.admit`` and one
``scheduler.retire`` a request and one ``scheduler.step`` a step; every
``model.prefill`` and ``kv_pool.admit`` inside an admission, every
``.sync`` span inside an admission or a retirement, a block's two halves
``n_layers`` times inside each prefill, every name of ``SPANS`` opened and
each opening one event of the trace.  The profiler moves no bit of the
tokens or the final logits, and with no profiler running no recorder is
entered.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core import spans
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import Request, RequestScheduler

SLOTS = 2


@pytest.fixture(scope="module")
def stream():
    """(engine, requests, slot capacity, layout)."""
    cfg = get_config("internlm2-1.8b").reduced()
    engine = ServingEngine(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(2, 8))).astype(np.int32),
                    max_new_tokens=int(rng.integers(1, 5)), arrival=a)
            for i, a in enumerate((0, 0, 1, 3, 3))]
    need = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    layout = engine.cache_layout(need)
    return engine, reqs, layout.padded_len(need), layout


def _scheduler(stream):
    engine, _, cap, layout = stream
    return RequestScheduler(engine.model, engine.params, SLOTS, cap,
                            layout=layout, device="cpu")


def _serve(stream, profiled: bool):
    """(results by rid, the scheduler, the spans recorded as (start ns,
    end ns, name), sorted, the names the recorder was opened with)."""
    reqs, sched = stream[1], _scheduler(stream)
    if not profiled:
        return {r.rid: r for r in sched.run(reqs)}, sched, [], []
    real, opened = torch._C._profiler._RecordFunctionFast, []

    def recorder(name):
        opened.append(name)
        return real(name)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch._C._profiler, "_RecordFunctionFast", recorder)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            results = sched.run(reqs)
    recorded = sorted(
        (int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns()), e.name())
        for e in prof.profiler.kineto_results.events() if e.name() in set(opened))
    return {r.rid: r for r in results}, sched, recorded, opened


@pytest.fixture(scope="module")
def traced(stream):
    return _serve(stream, profiled=True)


def _named(recorded, *names):
    return [(s, e) for s, e, n in recorded if n in names]


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_one_admit_and_retire_a_request_one_step_a_step(stream, traced):
    _, reqs, _, _ = stream
    results, sched, recorded, _ = traced
    assert len(results) == len(reqs)
    assert len(_named(recorded, "scheduler.admit")) == len(reqs)
    assert len(_named(recorded, "scheduler.retire")) == len(reqs)
    assert len(_named(recorded, "scheduler.step")) == sched.steps_run > 0


@pytest.mark.parametrize("child,parents", [
    ("model.prefill", ("scheduler.admit",)),
    ("kv_pool.admit", ("scheduler.admit",)),
    ("scheduler.sync", ("scheduler.admit", "scheduler.retire")),
    ("kv_pool.sync", ("scheduler.admit", "scheduler.retire")),
])
def test_span_lies_inside_its_parent(traced, child, parents):
    _, _, recorded, _ = traced
    kids, outer = _named(recorded, child), _named(recorded, *parents)
    assert kids
    for kid in kids:
        assert any(_inside(kid, o) for o in outer), (child, kid)


@pytest.mark.parametrize("half", ["model.prefill.attn", "model.prefill.ffn"])
def test_prefill_holds_each_block_half_once_a_layer(stream, traced, half):
    engine, reqs, _, _ = stream
    _, _, recorded, _ = traced
    prefills = _named(recorded, "model.prefill")
    halves = _named(recorded, half)
    assert len(prefills) == len(reqs)
    for p in prefills:
        assert sum(_inside(h, p) for h in halves) == engine.cfg.n_layers
    assert len(halves) == len(reqs) * engine.cfg.n_layers


def test_every_recorded_name_is_listed(traced):
    _, _, recorded, opened = traced
    assert set(opened) == set(spans.SPANS)  # the stream opens every span
    assert len(set(spans.SPANS)) == len(spans.SPANS)
    # each span opened is one event of the trace
    assert collections.Counter(n for _, _, n in recorded) == (
        collections.Counter(opened))


def test_the_profiler_moves_no_bit(stream, traced):
    plain, _, _, _ = _serve(stream, profiled=False)
    results = traced[0]
    assert plain.keys() == results.keys()
    for rid, r in results.items():
        np.testing.assert_array_equal(r.tokens, plain[rid].tokens)
        np.testing.assert_array_equal(r.final_logits, plain[rid].final_logits)
        assert (r.admitted_step, r.finished_step) == (
            plain[rid].admitted_step, plain[rid].finished_step)


@pytest.mark.parametrize("profiled", [False, True])
def test_recorders_entered_only_under_a_profiler(stream, traced, monkeypatch,
                                                 profiled):
    """With no profiler running, neither ``record_function`` nor the fast
    recorder is entered; under one, the fast recorder is, once a span."""
    entered = collections.Counter()
    real_rf = torch.autograd.profiler.record_function
    real_fast = torch._C._profiler._RecordFunctionFast

    class Counting(real_rf):
        def __enter__(self):
            entered["record_function"] += 1
            return super().__enter__()

    def fast(name):
        entered["fast"] += 1
        return real_fast(name)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", fast)
    sched = _scheduler(stream)
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            sched.run(stream[1])
        assert entered == {"fast": len(traced[3])}
    else:
        sched.run(stream[1])
        assert not entered
