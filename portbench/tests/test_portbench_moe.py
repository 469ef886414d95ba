"""The deepseek-moe-16b configuration's files: ``families/moe.py``'s schema
against the port's ``Moe`` module built on ``meta`` at full width (16,376 M
parameters), the parameters a token runs through, the configuration file's
published keys, the three moe readers on a synthetic trace (each reading
nothing where its kernels are absent), a tiny moe cell through the
harness on the CPU (the program exact against the plain reference, the fp8
control not correct), and the reference's imports."""

import json
import os
import shutil
import time
import types

import pytest

from pbcore import counts, moe_layer, spec, weights
from pbcore.readers import slice_steps

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
DATA = os.path.join(BENCH, "tests", "data")


def _config():
    with open(os.path.join(BENCH, "configs", "deepseek-moe-16b.json")) as f:
        return json.load(f)


def test_schema_is_the_ports_module_at_full_width():
    from entries.stream import _module, port_config

    m = _config()["model"]
    cfg = port_config(m)
    module = _module(cfg, m, "meta")
    params = dict(module.named_parameters())
    kinds = {n: k for k in weights.schema(m) for n in k.names()}
    assert set(params) == set(kinds)
    for name, p in params.items():
        k = kinds[name]
        assert tuple(p.shape) == tuple(k.shape), name
        assert str(p.dtype) == f"torch.{k.dtype}", name
    assert weights.param_count(m) == 16_375_728_128 == sum(
        p.numel() for p in params.values())
    assert params["moe_blocks.0.moe.router"].dtype.is_floating_point
    assert kinds["moe_blocks.0.moe.router"].dtype == "float32"
    assert kinds["moe_blocks.26.moe.w_down"].fan_in == 1408
    assert kinds["moe_blocks.0.moe.shared.wo"].fan_in == 2816


def test_body_params_per_token():
    m = _config()["model"]
    attn = 4 * 2048 * 2048
    moe = 3 * 2048 * 1408 * (6 + 2) + 2048 * 64
    assert counts.body_params_per_token(m) == (
        28 * attn + 3 * 2048 * 10944 + 27 * moe) == 2_409_103_360
    assert counts.prefill_flops(m, 1) == (
        2 * 2_409_103_360 + 2 * 2048 * 102400 + 4 * 16 * 128 * 28)


def test_the_file_states_the_published_model():
    c = _config()
    m = c["model"]
    assert (c["n_routed_experts"], c["num_experts_per_tok"],
            c["n_shared_experts"]) == (m["n_experts"], m["experts_per_token"],
                                       m["n_shared_experts"]) == (64, 6, 2)
    assert c["norm_topk_prob"] is m["moe_norm_topk_prob"] is False
    assert c["scoring_func"] == "softmax" and m["moe_capacity_factor"] is None
    assert m["moe_cache_dtype"] == m["kv_cache_dtype"] == "bfloat16"
    assert (m["norm_eps"], m["rope_theta"]) == (c["rms_norm_eps"],
                                                c["rope_theta"])
    assert (m["d_ff"], m["moe_d_ff"], m["first_dense_layers"]) == (
        c["intermediate_size"], c["moe_intermediate_size"],
        c["first_k_dense_replace"])
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    entry = {x["name"]: x for x in b["configs"]}["deepseek-moe-16b"]
    assert entry["reduced"] == [] and entry["source"] == c["source"]


# --------------------------------------------------------------------------
# the readers, on a synthetic trace


ROUTER = moe_layer.ROUTER[0]
GEMM = moe_layer.GEMM[0]


def _layer(t, attn_us, route_us, expert_us, combine_us, prefill=False,
           experts=moe_layer.EXPERTS):
    """The events of one layer from ``t`` (ns), the attention kernel (none
    in a prefill) before the moe section; returns (events, end)."""
    ev = []

    def add(name, us):
        nonlocal t
        ev.append((t, t + int(us * 1000), name))
        t += int(us * 1000) + 500

    if not prefill:
        add(moe_layer.DECODE_ATTN, attn_us)
    add(GEMM + "_out_proj", 4)
    add("rms_norm", 2)
    add(ROUTER + "_router", route_us[0])
    for us in route_us[1:]:
        add("sort_or_gather", us)
    for name, us in zip(experts, expert_us):
        add(name + "NNT", us)
        add("silu_mul", 1)
    ev.pop()                                     # no silu after the down product
    for us in combine_us:
        add("combine", us)
    for us in (7, 7, 7):
        add(GEMM + "_shared", us)
    add("residual_add", 1)
    return ev, t


def _record(device, steps=2, model=None):
    trace = types.SimpleNamespace(device=device, host=[])
    return types.SimpleNamespace(trace=trace, slice_steps=(10, 10 + steps),
                                 peaks={"hbm_bytes_per_s": 3.35e12},
                                 model=model or _config()["model"])


def _synthetic(experts=moe_layer.EXPERTS, expert_us=(10, 10, 5)):
    """Two decode steps of two moe layers each (a dense layer first),
    with a prefill of two moe layers between them."""
    ev, t = [], 0
    for step in range(2):
        e, t = _layer(t, 5, (3, 1, 1), (100, 100, 50), (2, 2), prefill=True)
        if step:
            ev += e                            # a prefill between the steps
        ev.append((t, t + 5000, moe_layer.DECODE_ATTN))    # the dense layer
        t += 6000
        for _ in range(2):
            e, t = _layer(t, 5, (3, 1, 1), expert_us, (2, 2),
                          experts=experts)
            ev += e
    return sorted(ev)


def _reader(name):
    return spec.reader(name)


def test_readers_on_a_synthetic_trace(monkeypatch):
    rec = _record(_synthetic())
    assert len(moe_layer.decode_sections(rec.trace.device)) == 4
    # 4 decode moe layers over 2 steps; the prefill's are left out
    assert _reader("moe_experts_ms")(rec) == pytest.approx(4 * 25e-3 / 2)
    assert _reader("moe_route_ms")(rec) == pytest.approx(4 * 9e-3 / 2)
    spans = types.SimpleNamespace(counters=lambda: {"moe.decode": {
        "layer_calls": 10.0, "experts_hit": 600.0, "assignments": 1920.0}})
    monkeypatch.setitem(__import__("sys").modules, "repro_torch.core.spans",
                        spans)
    m = rec.model
    per_layer = (60 * 3 * 2048 * 1408 * 2 + 192 * 2048 * (2 + 4))
    want = 100 * (4 * per_layer / 3.35e12) / (4 * 25e-6)
    assert _reader("moe_expert_roofline")(rec) == pytest.approx(want)
    assert moe_layer.expert_bytes_per_layer(m, 60, 192) == per_layer
    assert slice_steps(rec) == 2


def test_readers_read_nothing_without_their_kernels(monkeypatch):
    dense = [(0, 5000, moe_layer.DECODE_ATTN), (6000, 9000, GEMM + "_mlp")]
    for device in (dense, [(0, 10, "index_kernel")]):
        rec = _record(device)
        for name in ("moe_experts_ms", "moe_route_ms", "moe_expert_roofline"):
            assert _reader(name)(rec) is None, name
    rec = _record(_synthetic())
    rec_none = types.SimpleNamespace(**{**vars(rec), "trace": None})
    for name in ("moe_experts_ms", "moe_route_ms", "moe_expert_roofline"):
        assert _reader(name)(rec_none) is None
    # a program without routing counters (the parent's) reads no roofline
    monkeypatch.setitem(__import__("sys").modules, "repro_torch.core.spans",
                        types.SimpleNamespace())
    assert _reader("moe_expert_roofline")(rec) is None
    assert _reader("moe_experts_ms")(rec) is not None


@pytest.mark.parametrize("experts,expert_us", [
    (("cutlass_grouped_gemm_expert_",), (25,)),          # one grouped product
    (("nvjet_tss_384x32_", "nvjet_tss_512x32_"), (20, 5)),   # gate and up fused
    (("nvjet_tss_64x16_",) * 3, (10, 10, 5)),            # other kernels
])
def test_readers_read_nothing_where_the_experts_run_another_way(
        monkeypatch, experts, expert_us):
    """Where the routed experts' products are not the three known kernels
    no section is read, not a wrong one: the shared experts' products
    would otherwise be taken for the routed ones."""
    rec = _record(_synthetic(experts, expert_us))
    assert moe_layer.decode_sections(rec.trace.device) == []
    spans = types.SimpleNamespace(counters=lambda: {"moe.decode": {
        "layer_calls": 10.0, "experts_hit": 600.0, "assignments": 1920.0}})
    monkeypatch.setitem(__import__("sys").modules, "repro_torch.core.spans",
                        spans)
    for name in ("moe_experts_ms", "moe_route_ms", "moe_expert_roofline"):
        assert _reader(name)(rec) is None, name


# --------------------------------------------------------------------------
# a tiny moe cell through the harness, on the CPU


TINY = {
    "name": "tiny-moe", "family": "moe", "n_layers": 4, "d_model": 128,
    "n_heads": 4, "n_kv_heads": 4, "d_head": 32, "d_ff": 256,
    "vocab_size": 512, "padded_vocab": 512, "n_experts": 8,
    "n_shared_experts": 1, "experts_per_token": 2, "moe_d_ff": 64,
    "first_dense_layers": 1, "moe_capacity_factor": None,
    "moe_norm_topk_prob": False, "moe_cache_dtype": "float32",
    "rope_theta": 10000.0, "norm_eps": 1e-06, "tie_embeddings": False,
    "param_dtype": "float32", "kv_cache_dtype": "float32",
}


def _tiny_moe_cell(tmp_path):
    with open(os.path.join(DATA, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"] = [{"name": "tiny-moe", "source": "test",
                     "file": "configs/tiny-moe.json", "reduced": [],
                     "why": "test"}]
    b["workloads"] = [{"name": "tiny-moe-chat", "config": "tiny-moe",
                       "traffic": "tiny-chat", "chips": 1, "why": "test"}]
    for sub in ("configs", "cells", "traffic"):
        (tmp_path / sub).mkdir()
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "configs" / "tiny-moe.json").write_text(json.dumps(
        {"name": "tiny-moe", "entry": "stream", "reference": "moe",
         "model": TINY}))
    shutil.copy(os.path.join(DATA, "cells", "tiny-dense-chat.json"),
                tmp_path / "cells" / "tiny-moe-chat.json")
    shutil.copy(os.path.join(DATA, "traffic", "tiny-chat.json"),
                tmp_path / "traffic")
    return str(tmp_path)


@pytest.mark.parametrize("control", [False, True])
def test_a_tiny_moe_cell_runs_through_the_harness(tmp_path, control):
    from entries import stream
    from pbcore import runner

    root = _tiny_moe_cell(tmp_path)
    margin = stream.SIZE_MARGIN
    stream.SIZE_MARGIN = 3.0
    try:
        result, rec = runner.run(root, "tiny-moe-chat", 2**40 + 17, 1.5,
                                 False, time.perf_counter(), device="cpu",
                                 control=control, bench_dir=root)
    finally:
        stream.SIZE_MARGIN = margin
    assert result["failed"] == 0 and rec.extra["unfinished"] == 0
    # the program is exact against the plain reference; the control is not
    assert rec.extra["readings"]["widest_gap"] == 0.0
    assert result["correct"] is (not control)
    if control:
        assert rec.extra["control"]["mean_gap"] > 1e-3


def test_the_reference_imports_no_program():
    from reference import moe

    with open(moe.__file__) as f:
        src = f.read()
    for word in ("import repro", "from repro", "import jax", "from jax"):
        assert word not in src, word
