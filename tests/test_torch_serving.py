"""The port's dense LM serving path (``repro_torch.serving.engine`` →
``models.transformer`` → the attention backends) against the JAX package,
for the four dense configs at their ``reduced()`` size.

Both sides hold the same weights: the reference's ``transformer.init``
params, cast to fp32 (this image's CPU jax cannot run the bf16 dense path)
and carried over with ``transformer.params_from_arrays``.  Model-level
logits and caches are held to 1e-4, the reference's own fp32 tolerance
(``tests/test_attention_backends.py``): the two sides sum in different
orders.  Greedy tokens must be identical.  The port's bf16 path has no
reference here, so it is held to the port's own fp32 run within 3e-2, the
reference's bf16 logits tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.backends import (  # noqa: E402
    DenseRefAttention as RefDenseRef,
    KVCacheLayout as RefLayout,
    PallasSplitKAttention,
)
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import kvcache as ref_kvcache  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.serving.engine import ServingEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import backends  # noqa: E402
from repro_torch.core.backends import (  # noqa: E402
    ChunkedLseAttention,
    KVCacheLayout,
    TorchSplitKAttention,
)
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import attention, kvcache, transformer  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serving import router  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import Request  # noqa: E402
from _port_keys import as_port  # noqa: E402

ARCHS = ["internlm2-1.8b", "llama3.2-1b", "codeqwen1.5-7b", "minicpm-2b"]
BLOCK_K = 8
CAP = 16                     # decode cache capacity: two BLOCK_K blocks
B, S_PROMPT, NEW = 2, 6, 4
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
BACKENDS = {
    "dense-ref": lambda: backends.DenseRefAttention(),
    "chunked-lse": lambda: ChunkedLseAttention(kv_chunk=BLOCK_K),
    "torch-splitk": lambda: TorchSplitKAttention(block_k=BLOCK_K, device="cpu"),
}


def _edge_cache_lens(cap: int = CAP, block_k: int = BLOCK_K):
    """Valid-prefix edges: 0, 1, the block_k boundary, cap − 1."""
    lens = {0, 1, block_k - 1, block_k, block_k + 1, cap - 1}
    return sorted(l for l in lens if 0 <= l < cap)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(cfg, reference fp32 params, the port's fp32 params, prompts)."""
    cfg = get_config(request.param).reduced()
    ref_cfg = ref_get_config(request.param).reduced()
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          ref_transformer.init(jax.random.key(0), ref_cfg))
    port = transformer.params_from_arrays(
        cfg, jax.tree.map(np.asarray, params), device="cpu",
        dtype=torch.float32)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, size=(B, S_PROMPT)).astype(np.int32)
    return cfg, ref_cfg, params, port, prompts


@pytest.fixture(scope="module")
def prefilled(case):
    """Both sides' prefill at capacity CAP, and the first greedy token."""
    cfg, ref_cfg, params, port, prompts = case
    want_logits, want_cache = ref_transformer.prefill(
        params, jnp.asarray(prompts), ref_cfg, CAP, layout=RefLayout(BLOCK_K))
    logits, cache = transformer.prefill(
        port, torch.from_numpy(prompts).long(), cfg, CAP,
        layout=KVCacheLayout(BLOCK_K))
    token = np.asarray(jnp.argmax(want_logits, axis=-1)).astype(np.int32)
    return want_logits, want_cache, logits, cache, token


def test_configs_match_the_reference():
    for arch in ARCHS:
        port, ref = get_config(arch), ref_get_config(arch)
        assert dataclasses.asdict(port) == as_port(ref)
        assert dataclasses.asdict(port.reduced()) == as_port(ref.reduced())
        assert port.padded_vocab() == ref.padded_vocab()
        assert port.param_count() == ref.param_count()
    assert dataclasses.asdict(get_config("deepseek-moe-16b")) == \
        as_port(ref_get_config("deepseek-moe-16b"))
    assert dataclasses.asdict(get_config("sparse-dnn-graphchallenge")) == \
        as_port(ref_get_config("sparse-dnn-graphchallenge"))
    with pytest.raises(KeyError):
        get_config("gpt-9")


def test_params_carry_over_exactly(case):
    cfg, _, params, port, _ = case
    assert port.embed.dtype == torch.float32
    np.testing.assert_array_equal(_np(port.embed), np.asarray(params["embed"]))
    np.testing.assert_array_equal(
        _np(port.blocks[-1].attn.wo), np.asarray(params["blocks"]["attn"]["wo"][-1]))
    assert (port.unembed is None) == cfg.tie_embeddings
    assert sum(p.numel() for p in port.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))


def test_prefill_logits_and_cache_match(case, prefilled):
    want_logits, want_cache, logits, cache, _ = prefilled
    assert logits.shape == (B, 1, case[0].padded_vocab())
    np.testing.assert_allclose(_np(logits), _np(want_logits), **TOL)
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == want_cache[key].shape
        np.testing.assert_allclose(_np(cache[key]), _np(want_cache[key]), **TOL)
    assert int(cache["length"]) == int(want_cache["length"]) == S_PROMPT


def test_forward_logits_match(case, prefilled):
    """Teacher-forced logits at every position; the last one is prefill's."""
    cfg, ref_cfg, params, port, prompts = case
    got = transformer.forward(port, torch.from_numpy(prompts).long(), cfg)
    want = ref_transformer.forward(params, jnp.asarray(prompts), ref_cfg)
    assert got.shape == (B, S_PROMPT, cfg.padded_vocab())
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(got[:, -1:]), _np(prefilled[2]), **TOL)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_decode_step_logits_match_at_edge_cache_lens(case, prefilled, backend):
    cfg, ref_cfg, params, port, _ = case
    _, want_cache, _, cache, token = prefilled
    ref_step = jax.jit(lambda p, t, c: ref_transformer.decode_step(
        p, t, c, ref_cfg, attn_backend=RefDenseRef()))
    be = BACKENDS[backend]()
    for cache_len in _edge_cache_lens():
        c = dict(want_cache, length=jnp.asarray(cache_len, jnp.int32))
        want, want_next = ref_step(params, jnp.asarray(token), c)
        mine = {"k": cache["k"].clone(), "v": cache["v"].clone(),
                "length": torch.tensor(cache_len, dtype=torch.int32)}
        got, got_next = transformer.decode_step(
            port, torch.from_numpy(token).long(), mine, cfg, attn_backend=be)
        msg = f"{cfg.name}/{backend} cache_len={cache_len}"
        np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **TOL)
        np.testing.assert_allclose(_np(got_next["k"]), _np(want_next["k"]),
                                   err_msg=msg, **TOL)
        assert int(got_next["length"]) == cache_len + 1


def test_engine_tokens_equal_the_reference_engine(case):
    cfg, ref_cfg, params, port, prompts = case
    want = RefEngine(ref_cfg, params=params,
                     attn_backend=PallasSplitKAttention(block_k=BLOCK_K)
                     ).generate(prompts, max_new_tokens=NEW)
    eng = ServingEngine(cfg, params=port, device="cpu",
                        attn_backend=TorchSplitKAttention(block_k=BLOCK_K,
                                                          device="cpu"))
    assert eng.cache_layout(S_PROMPT + NEW).padded_len(S_PROMPT + NEW) == CAP
    got = eng.generate(prompts, max_new_tokens=NEW)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.prefill_logits, want.prefill_logits, **TOL)
    assert got.steps == NEW and got.tokens.dtype == np.int32


def test_bf16_path_stays_near_its_own_fp32_run(case, prefilled):
    """bf16 params and cache against the port's fp32 run: prefill and first
    decode-step logits within 3e-2."""
    cfg, _, params, port, prompts = case
    _, _, logits32, cache32, token = prefilled
    bf16 = transformer.params_from_arrays(
        cfg, jax.tree.map(np.asarray, params), device="cpu",
        dtype=torch.bfloat16)
    layout = KVCacheLayout(BLOCK_K)
    logits, cache = transformer.prefill(bf16, torch.from_numpy(prompts).long(),
                                        cfg, CAP, layout=layout)
    assert cache["k"].dtype == torch.bfloat16 and logits.dtype == torch.float32
    np.testing.assert_allclose(_np(logits), _np(logits32), **BF16_TOL)
    be = BACKENDS["torch-splitk"]()
    tok = torch.from_numpy(token).long()
    step, _ = transformer.decode_step(bf16, tok, cache, cfg, attn_backend=be)
    c32 = {k: v.clone() for k, v in cache32.items()}
    step32, _ = transformer.decode_step(port, tok, c32, cfg, attn_backend=be)
    np.testing.assert_allclose(_np(step), _np(step32), **BF16_TOL)


def test_attention_helpers_match_the_reference():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 10, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for causal in (True, False):
        want = ref_attention.chunked_causal_attention(
            jq, jk, jv, q_chunk=4, kv_chunk=3, causal=causal)
        got = attention.chunked_causal_attention(tq, tk, tv, q_chunk=4,
                                                 kv_chunk=3, causal=causal)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        np.testing.assert_allclose(
            _np(attention.full_attention(tq, tk, tv, causal=causal)),
            _np(ref_attention.full_attention(jq, jk, jv, causal=causal)), **TOL)
    layout = KVCacheLayout(BLOCK_K)
    np.testing.assert_array_equal(
        _np(kvcache.pad_kv_to_layout(tk, 10, layout)),
        np.asarray(ref_kvcache.pad_kv_to_layout(jk, 10, RefLayout(BLOCK_K))))


def test_splitk_capacity_equals_the_reference():
    """The split-KV table is kept as the padding rule: caches are as long
    as the reference's for every request length."""
    port = TorchSplitKAttention(device="cpu")
    ref = PallasSplitKAttention()
    for max_len in (1, 20, 256, 257, 544, 1000, 1025, 4097, 40000):
        assert (port.cache_layout(max_len).padded_len(max_len)
                == ref.cache_layout(max_len).padded_len(max_len))
    assert port.cache_layout(544).padded_len(544) == 640


def test_router_maps_platforms():
    cfg = get_config("internlm2-1.8b").reduced()
    assert router.route_attention_backend(cfg, platform="cuda") == "torch-splitk"
    assert router.route_attention_backend(cfg, max_len=32_768,
                                          platform="cpu") == "chunked-lse"
    assert router.route_attention_backend(cfg, max_len=512,
                                          platform="cpu") == "dense-ref"
    with pytest.raises(ValueError, match="platform"):
        router.route_attention_backend(cfg)
    plan = router.route_decode_plan(cfg, max_len=544, platform="cuda")
    assert plan.attn_backend == "torch-splitk"
    assert plan.cache_layout.padded_len(544) == 640
    later = router.route_decode_plan(cfg, platform="cuda")
    assert later.cache_layout is None and later.layout_for(544).block_k == 128
    assert router.route_decode_plan(cfg, 512, "cpu").cache_layout.block_k == 1
    eng = ServingEngine(cfg, attn_backend="auto", device="cpu")
    assert eng.attn_backend.name == "dense-ref"


def test_registry_and_engine_options():
    assert backends.ATTENTION_BACKEND_NAMES == (
        "dense-ref", "chunked-lse", "torch-splitk")
    assert backends.get_backend("attention", "chunked-lse").name == "chunked-lse"
    with pytest.raises(ValueError, match="unknown attention backend"):
        backends.get_backend("attention", "pallas-splitk")
    cfg = get_config("internlm2-1.8b").reduced()
    eng = ServingEngine(cfg, device="cpu")
    assert eng.attn_backend.name == "torch-splitk"
    assert eng.params.embed.dtype == torch.bfloat16
    # the sequence-sharded stream: at the default block_k (64 here) a
    # capacity of 128 splits into two shards; its tokens are the unsharded
    # stream's, and a capacity that does not split raises
    reqs = [Request(rid=i, prompt=np.arange(3 + i, dtype=np.int32),
                    max_new_tokens=2) for i in range(2)]
    mesh = make_mesh((2,), ("seq",), ["cpu", "cpu"])
    plain = {r.rid: r.tokens for r in eng.generate_stream(
        reqs, num_slots=2, max_request_len=128)}
    sharded = eng.generate_stream(reqs, num_slots=2, max_request_len=128,
                                  mesh=mesh, axis_name="seq")
    assert sorted(r.rid for r in sharded) == [0, 1]
    for r in sharded:
        np.testing.assert_array_equal(r.tokens, plain[r.rid])
    with pytest.raises(ValueError, match="sequence shards"):
        eng.generate_stream(reqs, max_request_len=64, mesh=mesh)
    fabric = ServingEngine(cfg, device="cpu", engine="fabric", pipeline_P=2)
    assert (fabric.engine, fabric.pipeline_P, fabric.pipeline_channel) == (
        "fabric", 2, "queue")
    with pytest.raises(ValueError, match="unknown engine"):
        ServingEngine(cfg, device="cpu", engine="bogus")
    with pytest.raises(ValueError, match="unknown family"):
        get_model(dataclasses.replace(cfg, family="bogus"))


def test_cuda_defaults_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("internlm2-1.8b").reduced()
    for make in (lambda: ServingEngine(cfg),
                 lambda: backends.get_backend("attention", None),
                 lambda: backends.get_backend("attention", "torch-splitk"),
                 lambda: get_model(cfg)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            make()


def test_cpu_serving_launches_no_kernel_and_the_launcher_runs(capsys):
    before = dict(decode_ops.LAUNCHES)
    assert serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "5",
                       "--max-new", "3"]) == 0
    assert decode_ops.LAUNCHES == before
    assert "torch-splitk on cpu: generated (2, 3)" in capsys.readouterr().out
