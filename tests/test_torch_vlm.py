"""The port's vlm family (internvl2-2b: the dense transformer with the stub
frontend's patch embeddings prepended, ``extra_embeds``) against the JAX
package's, on the CPU, at ``internvl2-2b.reduced()`` (4 layers, d_model
128, 4 heads over 2 KV heads, 8 image embeddings).

Both sides hold the same weights: the reference's ``transformer.init``
params cast to fp32 (this image's CPU jax cannot run the bf16 LM path),
carried over with ``transformer.params_from_arrays``; prompts and
embeddings come from a seeded numpy generator.  Logits and caches are held
to 1e-4 (the reference's fp32 model tolerance) and greedy tokens must be
identical to the reference's engine.  Through the LM pipeline over the
fabric (``extra`` on the embedding stage): tokens and logits bit for bit
the port's device engine, and against the reference's pipeline identical
tokens, logits within 1e-4, every billed count exactly equal, cost within
5% and worker times within 2% (as ``tests/test_torch_lm_pipeline.py``).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.backends import DenseRefAttention as RefDenseRef  # noqa: E402
from repro.core.backends import KVCacheLayout as RefLayout  # noqa: E402
from repro.core.backends import PallasSplitKAttention  # noqa: E402
from repro.faas import lm_pipeline as ref_pipeline  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.serving.engine import ServingEngine as RefEngine  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.core.backends import (  # noqa: E402
    ChunkedLseAttention,
    DenseRefAttention,
    KVCacheLayout,
    TorchSplitKAttention,
)
from repro_torch.faas.lm_pipeline import (  # noqa: E402
    build_stage_executors,
    run_lm_pipeline,
)
from repro_torch.models import registry, transformer  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from _port_keys import as_port  # noqa: E402

ARCH = "internvl2-2b"
BLOCK_K = 8
CAP = 24                     # decode capacity: 8 embeddings, 6 tokens, room
B, S_PROMPT, NEW = 2, 6, 4
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
BACKENDS = {
    "dense-ref": lambda: DenseRefAttention(),
    "chunked-lse": lambda: ChunkedLseAttention(kv_chunk=BLOCK_K),
    "torch-splitk": lambda: TorchSplitKAttention(block_k=BLOCK_K, device="cpu"),
}
BILLED_COUNTS = ("P", "memory_mb", "publish_units", "sqs_api_calls",
                 "s3_puts", "s3_gets", "s3_lists")


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _case():
    """(cfg, reference cfg, reference fp32 params, the port's fp32 params,
    prompts, image embeddings fp32)."""
    cfg, ref_cfg = get_config(ARCH).reduced(), ref_get_config(ARCH).reduced()
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          ref_transformer.init(jax.random.key(0), ref_cfg))
    port = transformer.params_from_arrays(cfg, jax.tree.map(np.asarray, params),
                                          device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, size=(B, S_PROMPT)).astype(np.int32)
    embeds = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)
                                 ).astype(np.float32)
    return cfg, ref_cfg, params, port, prompts, embeds


@pytest.fixture(scope="module")
def case():
    return _case()


@pytest.fixture(scope="module")
def prefilled(case):
    cfg, ref_cfg, params, port, prompts, embeds = case
    want_logits, want_cache = ref_transformer.prefill(
        params, jnp.asarray(prompts), ref_cfg, CAP,
        extra_embeds=jnp.asarray(embeds), layout=RefLayout(BLOCK_K))
    logits, cache = transformer.prefill(
        port, torch.from_numpy(prompts).long(), cfg, CAP,
        extra_embeds=torch.from_numpy(embeds), layout=KVCacheLayout(BLOCK_K))
    token = np.asarray(jnp.argmax(want_logits, axis=-1)).astype(np.int32)
    return want_logits, want_cache, logits, cache, token


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


def test_config_matches_the_reference():
    port, ref = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(port) == as_port(ref)
    assert dataclasses.asdict(port.reduced()) == as_port(ref.reduced())
    assert port.param_count() == ref.param_count()
    assert 1.5e9 <= port.param_count() <= 2.6e9
    assert (port.family, port.frontend_tokens, port.d_head) == ("vlm", 256, 128)


def test_params_carry_over_exactly(case):
    _, _, params, port, _, _ = case
    np.testing.assert_array_equal(_np(port.blocks[3].attn.wk),
                                  np.asarray(params["blocks"]["attn"]["wk"][3]))
    np.testing.assert_array_equal(_np(port.unembed), np.asarray(params["unembed"]))


def test_forward_logits_match(case, prefilled):
    cfg, ref_cfg, params, port, prompts, embeds = case
    got = transformer.forward(port, torch.from_numpy(prompts).long(), cfg,
                              extra_embeds=torch.from_numpy(embeds))
    want = ref_transformer.forward(params, jnp.asarray(prompts), ref_cfg,
                                   extra_embeds=jnp.asarray(embeds))
    assert got.shape == (B, cfg.frontend_tokens + S_PROMPT, cfg.padded_vocab())
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(got[:, -1:]), _np(prefilled[2]), **TOL)


def test_prefill_logits_and_cache_match(case, prefilled):
    cfg = case[0]
    want_logits, want_cache, logits, cache, _ = prefilled
    np.testing.assert_allclose(_np(logits), _np(want_logits), **TOL)
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == want_cache[key].shape
        np.testing.assert_allclose(_np(cache[key]), _np(want_cache[key]), **TOL)
    assert int(cache["length"]) == int(want_cache["length"]) \
        == cfg.frontend_tokens + S_PROMPT


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_decode_step_logits_match_at_edge_cache_lens(case, prefilled, backend):
    """Lengths inside the image prefix, at its end and at the block edges."""
    cfg, ref_cfg, params, port, _, _ = case
    _, want_cache, _, cache, token = prefilled
    ref_step = jax.jit(lambda p, t, c: ref_transformer.decode_step(
        p, t, c, ref_cfg, attn_backend=RefDenseRef()))
    be = BACKENDS[backend]()
    F = cfg.frontend_tokens
    for cache_len in (0, 1, F - 1, F, F + 1, 2 * BLOCK_K, CAP - 1):
        c = dict(want_cache, length=jnp.asarray(cache_len, jnp.int32))
        want, want_next = ref_step(params, jnp.asarray(token), c)
        mine = {k: v.clone() for k, v in cache.items()}
        mine["length"] = torch.tensor(cache_len, dtype=torch.int32)
        got, got_next = transformer.decode_step(
            port, torch.from_numpy(token).long(), mine, cfg, attn_backend=be)
        msg = f"{backend} cache_len={cache_len}"
        np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **TOL)
        np.testing.assert_allclose(_np(got_next["k"]), _np(want_next["k"]),
                                   err_msg=msg, **TOL)


def test_generate_tokens_equal_the_reference_engine(case):
    """``extra={"extra_embeds": ...}`` through both sides' engines and
    split-KV backends: identical greedy tokens, logits within 1e-4."""
    cfg, ref_cfg, params, port, prompts, embeds = case
    extra = {"extra_embeds": embeds}
    want = RefEngine(ref_cfg, params=params,
                     attn_backend=PallasSplitKAttention(block_k=BLOCK_K)
                     ).generate(prompts, max_new_tokens=NEW, extra=extra)
    eng = ServingEngine(cfg, params=port, device="cpu",
                        attn_backend=TorchSplitKAttention(block_k=BLOCK_K,
                                                          device="cpu"))
    got = eng.generate(prompts, max_new_tokens=NEW, extra=extra)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.prefill_logits, want.prefill_logits, **TOL)
    again = eng.generate(prompts, max_new_tokens=NEW,
                         extra={"extra_embeds": torch.from_numpy(embeds)})
    np.testing.assert_array_equal(again.tokens, got.tokens)


def test_bf16_path_stays_near_its_own_fp32_run(case, prefilled):
    cfg, _, params, port, prompts, embeds = case
    _, _, logits32, cache32, token = prefilled
    bf16 = transformer.params_from_arrays(cfg, jax.tree.map(np.asarray, params),
                                          device="cpu", dtype=torch.bfloat16)
    logits, cache = transformer.prefill(
        bf16, torch.from_numpy(prompts).long(), cfg, CAP,
        extra_embeds=torch.from_numpy(embeds), layout=KVCacheLayout(BLOCK_K))
    assert cache["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(logits), _np(logits32), **BF16_TOL)
    be = BACKENDS["torch-splitk"]()
    tok = torch.from_numpy(token).long()
    step, _ = transformer.decode_step(bf16, tok, cache, cfg, attn_backend=be)
    step32, _ = transformer.decode_step(
        port, tok, {k: v.clone() for k, v in cache32.items()}, cfg,
        attn_backend=be)
    np.testing.assert_allclose(_np(step), _np(step32), **BF16_TOL)


def test_vlm_decode_matches_forward():
    """The port of ``tests/test_models_smoke.py``'s decode check for the
    vlm family: the batch from ``input_specs`` (image embeddings from the
    seed), the port's own random bf16 weights; the decode of token 8 after
    a prefill of 8 gives the forward pass's logits at that position
    (2e-2, the smoke test's tolerance)."""
    cfg = get_config(ARCH).reduced()
    api = registry.get_model(cfg, attn_backend=BACKENDS["torch-splitk"]())
    params = api.init(torch.Generator().manual_seed(1))
    batch = registry.input_specs(cfg, ShapeConfig("smoke", 9, 2, "train"),
                                 abstract=False, seed=0)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 9))).long()
    full = api.forward(params, {**batch, "tokens": toks})
    n_extra = full.shape[1] - 9
    assert n_extra == cfg.frontend_tokens
    pre = {"tokens": toks[:, :8], "extra_embeds": batch["extra_embeds"]}
    _, cache = api.prefill(params, pre, 16 + cfg.frontend_tokens)
    dec, _ = api.decode_step(params, toks[:, 8:9], cache)
    np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, n_extra + 8]),
                               rtol=2e-2, atol=2e-2)


def test_registry_specs_match_the_reference(case):
    cfg, ref_cfg = case[0], case[1]
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("s", 16, B, kind)
        want = ref_registry.input_specs(ref_cfg, shape)
        got = registry.input_specs(cfg, shape)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    shape = ShapeConfig("d", 16, B, "decode")
    want = ref_registry.cache_specs(ref_cfg, shape)
    got = registry.cache_specs(cfg, shape)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


# ---------------------------------------------------------------------------
# the pipeline over the fabric, with the image embeddings on stage 0
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _engine_run():
    cfg, _, _, port, prompts, embeds = _case()
    engine = ServingEngine(cfg, params=port, device="cpu")
    return engine, engine.generate(prompts, max_new_tokens=NEW,
                                   extra={"extra_embeds": embeds})


@functools.lru_cache(maxsize=None)
def _ref_executors(P):
    _, ref_cfg, params, *_ = _case()
    return ref_pipeline.build_stage_executors(
        ref_cfg, params, P, attn_backend=PallasSplitKAttention())


PIPE_CASES = [(P, ch) for P in (2, 4) for ch in ("queue", "object")]


@pytest.mark.parametrize("P,channel", PIPE_CASES,
                         ids=[f"P{P}-{c}" for P, c in PIPE_CASES])
def test_pipeline_matches_the_engine_and_the_reference(P, channel):
    cfg, ref_cfg, params, port, prompts, embeds = _case()
    engine, dev = _engine_run()
    executors = build_stage_executors(cfg, port, P,
                                      attn_backend=engine.attn_backend)
    got = run_lm_pipeline(cfg, prompts, port, max_new_tokens=NEW, P=P,
                          channel=channel, extra=embeds, executors=executors)
    np.testing.assert_array_equal(got.tokens, dev.tokens)
    assert np.array_equal(got.logits, dev.prefill_logits), \
        "pipeline logits are not bit for bit the device engine's"
    assert int(executors[0].cache["length"]) == cfg.frontend_tokens + S_PROMPT + NEW
    want = ref_pipeline.run_lm_pipeline(
        ref_cfg, prompts, params, max_new_tokens=NEW, P=P, channel=channel,
        extra=jnp.asarray(embeds), executors=_ref_executors(P))
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logits, want.logits, **TOL)
    assert dataclasses.astuple(got.plan) == dataclasses.astuple(want.plan)
    for f in BILLED_COUNTS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert got.raw_exchange_bytes == want.raw_exchange_bytes
    for key in ("flops_total", "hops"):
        assert got.metrics[key] == want.metrics[key], key
    assert got.cost.total == pytest.approx(want.cost.total, rel=0.05)
    np.testing.assert_allclose(got.worker_times, want.worker_times, rtol=0.02)
    assert [ex.weight_bytes for ex in executors] == \
        [ex.weight_bytes for ex in _ref_executors(P)]


def test_engine_fabric_path_and_stream_take_the_embeddings():
    """``ServingEngine(engine="fabric")`` hands the pipeline the embeddings
    of ``extra``; its stream serves each request alone with its own."""
    from repro_torch.serving.scheduler import Request

    cfg, _, _, port, prompts, embeds = _case()
    _, dev = _engine_run()
    fab = ServingEngine(cfg, params=port, device="cpu", engine="fabric",
                        pipeline_P=2)
    got = fab.generate(prompts, max_new_tokens=NEW,
                       extra={"extra_embeds": embeds})
    np.testing.assert_array_equal(got.tokens, dev.tokens)
    assert got.fabric is not None and got.fabric.plan.P == 2
    reqs = [Request(i, prompts[i], NEW, extra={"extra_embeds": embeds[i:i + 1]})
            for i in range(B)]
    for r in fab.generate_stream(reqs):
        np.testing.assert_array_equal(r.tokens, dev.tokens[r.rid])
