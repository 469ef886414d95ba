"""The readers of the program's spans (``metrics/prefill_host_ms.py``,
``admit_idle_ms.py``, ``host_sync_ms.py``, ``host_syncs_per_step.py``,
``step_launch_ms.py``) on a slice built by hand, each value worked on
paper; None with no trace and with no spans (the program before it
recorded any); and every span name a reader reads is one the program
lists (``repro_torch.core.spans.SPANS``)."""

import importlib.util
import os
import types

import pytest

from pbcore import spec
from pbcore.trace import TraceData
from repro_torch.core.spans import SPANS

READERS = ("prefill_host_ms", "admit_idle_ms", "host_sync_ms",
           "host_syncs_per_step", "step_launch_ms")


def _module(name):
    path = os.path.join(spec.HERE, "metrics", name + ".py")
    s = importlib.util.spec_from_file_location(f"spans_reader_{name}", path)
    module = importlib.util.module_from_spec(s)
    s.loader.exec_module(module)
    return module


def _us(a, b, name):
    return (int(a * 1000), int(b * 1000), name)


# Two slice steps, in us.  Step 0 launches in [0, 1000] and runs on the
# card in [500, 20000]; its retirement [1000, 22000] waits for it in one
# copy [1200, 20200] and makes another [20300, 20400]; the card idles
# [20000, 22000] inside it.  The admission [22000, 30000] prefills in
# [22500, 28000] (kernels [23000, 24000] and [25000, 26000]), pages in at
# [28000, 29000] (its copy [28100, 28200], a kernel [28300, 28500]) and
# uploads in [29100, 29300].  Step 1 launches in [30000, 32000] and runs
# in [31000, 50000]; the card idles [30000, 31000] outside every span.
HOST = [
    _us(0, 1000, "scheduler.step"),
    _us(100, 900, "cudaGraphLaunch"),
    _us(1000, 22000, "scheduler.retire"),
    _us(1200, 20200, "scheduler.sync"),
    _us(1250, 20150, "aten::copy_"),
    _us(20300, 20400, "scheduler.sync"),
    _us(22000, 30000, "scheduler.admit"),
    _us(22500, 28000, "model.prefill"),
    _us(22600, 24500, "model.prefill.attn"),
    _us(24500, 27900, "model.prefill.ffn"),
    _us(28000, 29000, "kv_pool.admit"),
    _us(28100, 28200, "kv_pool.sync"),
    _us(29100, 29300, "scheduler.sync"),
    _us(30000, 32000, "scheduler.step"),
]
DEVICE = [
    _us(500, 20000, "gather"),
    _us(23000, 24000, "nvjet"),
    _us(25000, 26000, "nvjet"),
    _us(28300, 28500, "index_copy"),
    _us(31000, 50000, "gather"),
]
# (reader, value): the prefill 5.5 ms; the union of admission and
# retirement [1000, 30000] is 29 ms, of which the card ran 19 + 1 + 1 +
# 0.2 ms, so 7.8 ms idle over one admission; the copies 19 + 0.1 + 0.1 +
# 0.2 ms and 4 of them over 2 steps; the launches 1 and 2 ms
EXPECTED = {"prefill_host_ms": 5.5, "admit_idle_ms": 7.8,
            "host_sync_ms": 19.4 / 2, "host_syncs_per_step": 2.0,
            "step_launch_ms": 1.5}


def _rec(host, device=DEVICE):
    return types.SimpleNamespace(
        trace=TraceData(device=sorted(device), host=sorted(host)),
        slice_steps=(10, 12))


@pytest.mark.parametrize("name", READERS)
def test_reader_value_worked_on_paper(name):
    assert spec.reader(name)(_rec(HOST)) == pytest.approx(EXPECTED[name],
                                                          abs=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_trace_or_spans(name):
    read = spec.reader(name)
    assert read(types.SimpleNamespace(trace=None, slice_steps=(0, 0))) is None
    ops_only = [h for h in HOST if h[2] not in SPANS]
    assert ops_only and read(_rec(ops_only)) is None


@pytest.mark.parametrize("name", ["host_sync_ms", "host_syncs_per_step"])
def test_a_slice_without_blocking_copies_reads_zero(name):
    steps = [h for h in HOST if h[2] == "scheduler.step"]
    assert spec.reader(name)(_rec(steps)) == 0.0


def test_admit_idle_needs_an_admission():
    no_admit = [h for h in HOST if h[2] != "scheduler.admit"]
    assert spec.reader("admit_idle_ms")(_rec(no_admit)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_only_listed_spans(name):
    module = _module(name)
    assert module.SPANS and set(module.SPANS) <= set(SPANS)


@pytest.mark.parametrize("name", ["host_sync_ms", "host_syncs_per_step"])
def test_sync_readers_read_every_sync_span(name):
    listed = {n for n in SPANS if n.endswith(".sync")}
    assert listed and listed == set(_module(name).SYNCS)


def test_readers_are_declared_per_layer_in_the_cell():
    import json

    with open(os.path.join(os.path.dirname(spec.HERE), "BENCHMARK.json")) as f:
        bench = json.load(f)
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["source"] == "program_span"
        assert m["workloads"] == ["internlm2-chat"]
