"""A model family is a file, ``families/<family>.py``: the weights and the
counts it gives are pinned at the values the dense decoder had before its
code moved there, a second family joins by new files alone, and a
configuration whose family has no file fails when its cell loads."""

import filecmp
import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from pbcore import counts, spec, weights

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
DATA = os.path.join(BENCH, "tests", "data")

# (index, name, layers, shape, dtype, init, fan-in) of internlm2-1.8b: the
# index seeds the kind's generator, so the order is part of the weights
INTERNLM2_SCHEMA = [
    (0, "embed", 0, (92672, 2048), "bfloat16", "embed", 1),
    (1, "blocks.ln_attn", 24, (2048,), "bfloat16", "ones", 1),
    (2, "blocks.attn.wq", 24, (2048, 16, 128), "bfloat16", "normal", 2048),
    (3, "blocks.attn.wk", 24, (2048, 8, 128), "bfloat16", "normal", 2048),
    (4, "blocks.attn.wv", 24, (2048, 8, 128), "bfloat16", "normal", 2048),
    (5, "blocks.attn.wo", 24, (16, 128, 2048), "bfloat16", "normal", 2048),
    (6, "blocks.ln_mlp", 24, (2048,), "bfloat16", "ones", 1),
    (7, "blocks.mlp.wi_gate", 24, (2048, 8192), "bfloat16", "normal", 2048),
    (8, "blocks.mlp.wi_up", 24, (2048, 8192), "bfloat16", "normal", 2048),
    (9, "blocks.mlp.wo", 24, (8192, 2048), "bfloat16", "normal", 8192),
    (10, "ln_f", 0, (2048,), "bfloat16", "ones", 1),
    (11, "unembed", 0, (92672, 2048), "bfloat16", "embed", 1),
]


def _model(path):
    with open(path) as f:
        return json.load(f)["model"]


def test_internlm2_schema_is_pinned():
    m = _model(os.path.join(BENCH, "configs", "internlm2-1.8b.json"))
    got = [(i, f"{k.prefix}.{k.suffix}" if k.layers else k.suffix, k.layers,
            k.shape, k.dtype, k.init, k.fan_in)
           for i, k in enumerate(weights.schema(m))]
    assert got == INTERNLM2_SCHEMA


@pytest.mark.parametrize("seed,digest", [
    (7, "6a34d89966746f52df2c95e1c0244a8e5d49b4d002984c838c2705eece8a0209"),
    (2**33 + 3,
     "9547ed63f605512f17044f395cb20be42d5221f951546c52dc35d9bd95dff75f"),
])
def test_tiny_dense_draws_are_pinned(seed, digest):
    """SHA-256 over every tensor ``draw_all`` gives, in schema order."""
    m = _model(os.path.join(DATA, "configs", "tiny-dense.json"))
    h = hashlib.sha256()
    for _, t in weights.draw_all(m, seed, "cpu"):
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == digest


@pytest.mark.parametrize("count,args,value", [
    ("body", (), 1509949440),
    ("prefill", (1,), 3399680000),
    ("prefill", (70,), 212261076992),
    ("prefill", (512,), 1572387946496),
    ("decode", (128, 36000), 442211762176),
    ("decode", (128, 196608), 473788579840),
    ("decode_attn_bytes", (1, 1), 12292),
    ("decode_attn_bytes", (128, 36000), 148505088),
    ("decode_attn_bytes", (128, 196608), 806355456),
])
def test_internlm2_counts_are_pinned(count, args, value):
    m = _model(os.path.join(BENCH, "configs", "internlm2-1.8b.json"))
    fn = {"body": counts.body_params_per_token, "prefill": counts.prefill_flops,
          "decode": counts.decode_flops,
          "decode_attn_bytes": counts.decode_attn_bytes}[count]
    assert fn(m, *args) == value


# A throwaway family for the port's ``Moe`` module: dense first layers,
# then blocks whose ffn is a fp32 router, stacked experts and shared
# experts.  It is written into a copy of the benchmark only.
MOE_FAMILY = '''
from pbcore import counts
from pbcore.weights import Kind


def _attn(m, prefix, n):
    d, H, KV, Dh = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_head"]
    dt = m["param_dtype"]
    return [Kind(prefix, "ln_attn", n, (d,), dt, "ones"),
            Kind(prefix, "attn.wq", n, (d, H, Dh), dt, "normal", d),
            Kind(prefix, "attn.wk", n, (d, KV, Dh), dt, "normal", d),
            Kind(prefix, "attn.wv", n, (d, KV, Dh), dt, "normal", d),
            Kind(prefix, "attn.wo", n, (H, Dh, d), dt, "normal", H * Dh),
            Kind(prefix, "ln_mlp", n, (d,), dt, "ones")]


def _mlp(m, prefix, name, n, f):
    d, dt = m["d_model"], m["param_dtype"]
    return [Kind(prefix, name + ".wi_gate", n, (d, f), dt, "normal", d),
            Kind(prefix, name + ".wi_up", n, (d, f), dt, "normal", d),
            Kind(prefix, name + ".wo", n, (f, d), dt, "normal", f)]


def block_kinds(m):
    fd, n = m["first_dense_layers"], m["n_layers"] - m["first_dense_layers"]
    d, E, f, dt = m["d_model"], m["n_experts"], m["moe_d_ff"], m["param_dtype"]
    kinds = []
    if fd:
        kinds += _attn(m, "dense_blocks", fd)
        kinds += _mlp(m, "dense_blocks", "mlp", fd, m["d_ff"])
    kinds += _attn(m, "moe_blocks", n)
    kinds += [Kind("moe_blocks", "moe.router", n, (d, E), "float32", "normal", d),
              Kind("moe_blocks", "moe.w_gate", n, (E, d, f), dt, "normal", d),
              Kind("moe_blocks", "moe.w_up", n, (E, d, f), dt, "normal", d),
              Kind("moe_blocks", "moe.w_down", n, (E, f, d), dt, "normal", f)]
    kinds += _mlp(m, "moe_blocks", "moe.shared", n, f * m["n_shared_experts"])
    return kinds


def body_params_per_token(m):
    fd, n = m["first_dense_layers"], m["n_layers"] - m["first_dense_layers"]
    d, f = m["d_model"], m["moe_d_ff"]
    active = m["experts_per_token"] + m["n_shared_experts"]
    return (m["n_layers"] * counts._attn_params(m) + fd * 3 * d * m["d_ff"]
            + n * (d * m["n_experts"] + 3 * d * f * active))
'''

# configs/deepseek_moe_16b.py's ``reduced()`` shape, in fp32
TINY_MOE = {
    "name": "tiny-moe", "family": "moe", "n_layers": 4, "d_model": 128,
    "n_heads": 4, "n_kv_heads": 4, "d_head": 32, "d_ff": 256,
    "vocab_size": 512, "padded_vocab": 512, "n_experts": 8,
    "n_shared_experts": 1, "experts_per_token": 2, "moe_d_ff": 64,
    "first_dense_layers": 1, "rope_theta": 10000.0, "norm_eps": 1e-05,
    "tie_embeddings": False, "param_dtype": "float32",
    "kv_cache_dtype": "float32",
}

FILL_MOE = """
import sys
sys.path[:0] = [sys.argv[1], sys.argv[3]]
import torch
from entries.stream import _module, port_config
from pbcore import counts, spec, weights
assert spec.HERE == sys.argv[1], spec.HERE
c = spec.load_cell(sys.argv[2], "tiny-moe-chat")
assert spec.family_file("moe") == sys.argv[1] + "/families/moe.py"
m = c.config["model"]
cfg = port_config(m)
module = _module(cfg, m, "cpu")
assert type(module).__name__ == "Moe", type(module)
n = weights.fill(module, m, seed=2**40 + 9)
params = dict(module.named_parameters())
assert n == weights.param_count(m) == sum(p.numel() for p in params.values())
assert params["moe_blocks.0.moe.router"].dtype == torch.float32
for kind, t in weights.draw_all(m, 2**40 + 9, "cpu"):
    for name, part in zip(kind.names(), t.unbind(0) if kind.layers else (t,)):
        assert torch.equal(params[name], part), name
flops = counts.prefill_flops(m, 7)
assert isinstance(flops, int) and flops > 0
print("ok", n, flops)
"""


def _copy(tmp_path):
    """A copy of the benchmark (its BENCHMARK.json and ``portbench/``)."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    copy = tmp_path / "portbench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    return copy


def _add_cell(tmp_path, copy, model, cell):
    (copy / "configs" / f"{model['name']}.json").write_text(json.dumps(
        {"name": model["name"], "entry": "stream", "reference": model["family"],
         "model": model}))
    (copy / "cells" / f"{cell}.json").write_text(json.dumps(
        {"check_requests": 2, "limits": {"widest_gap": 0.2}}))
    with open(tmp_path / "BENCHMARK.json") as f:
        b = json.load(f)
    b["configs"].append({"name": model["name"], "source": "x",
                         "file": f"portbench/configs/{model['name']}.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": cell, "config": model["name"],
                           "traffic": "lmsys-chat-128", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))


def _unchanged(copy):
    """No file of the benchmark differs in the copy; only new ones."""
    def walk(cmp):
        assert not cmp.diff_files and not cmp.funny_files, cmp.left
        assert not cmp.left_only, cmp.left_only
        for sub in cmp.subdirs.values():
            walk(sub)
    walk(filecmp.dircmp(BENCH, copy, ignore=["__pycache__"]))


def test_a_new_family_is_files_alone(tmp_path):
    """A throwaway ``families/moe.py`` and a configuration and cell that
    name it, in a copy of the benchmark: the cell loads, ``weights.fill``
    fills the port's ``Moe`` module exactly, the counts count."""
    copy = _copy(tmp_path)
    (copy / "families" / "moe.py").write_text(MOE_FAMILY)
    _add_cell(tmp_path, copy, TINY_MOE, "tiny-moe-chat")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", FILL_MOE, str(copy), str(tmp_path),
         os.path.join(ROOT, "src")],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.stdout.startswith("ok"), out.stderr[-3000:]
    _unchanged(copy)


MISSING = """
import sys
sys.path.insert(0, sys.argv[1])
from pbcore import spec
try:
    spec.load_cell(sys.argv[2], "tiny-nofam-chat")
except FileNotFoundError as err:
    print(err)
"""


def test_a_missing_family_fails_at_load(tmp_path):
    """The copy first on the import path: its ``load_cell`` refuses the
    configuration and names the file missing from the copy."""
    copy = _copy(tmp_path)
    _add_cell(tmp_path, copy, dict(TINY_MOE, name="tiny-nofam", family="nofam"),
              "tiny-nofam-chat")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", MISSING, str(copy), str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120)
    assert os.path.join(str(copy), "families", "nofam.py") in out.stdout, (
        out.stdout + out.stderr[-3000:])
    _unchanged(copy)
