"""The port's encoder-decoder family (``repro_torch.models.encdec``,
seamless-m4t-medium) against the JAX package's, on the CPU, at
``seamless-m4t-medium.reduced()`` (2 encoder and 4 decoder layers,
d_model 128, 8 source frames).

Both sides hold the same weights: the reference's ``encdec.init`` params
cast to fp32 (this image's CPU jax cannot run the bf16 LM path) and
carried over with ``encdec.params_from_arrays``; the source frames come
from a seeded numpy generator and go to bf16 on both sides, as the
reference casts them, so the encoder runs bf16 activations against fp32
weights on both.  XLA fuses the reference's encoder and, by default,
skips some of the bf16 roundings its code asks for
(``xla_allow_excess_precision``): then a third of the encoder's outputs
miss the port's by a bf16 rounding.  So the reference's functions here are
compiled with that option off (:func:`strict_jit`), which gives the
roundings the code states, and the port's encoder then equals it bit for
bit.  Logits and caches (self and cross K and V) are held to 1e-4, the
reference's fp32 model tolerance; greedy tokens must be identical to the
reference's engine; the port's bf16 path stays within 3e-2 of its own fp32
run.  Also the port of
``tests/test_models_smoke.py::test_encdec_decode_matches_forward``.
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
from repro.models import encdec as ref_encdec  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.serving.engine import ServingEngine as RefEngine  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.core.backends import (  # noqa: E402
    ChunkedLseAttention,
    DenseRefAttention,
    KVCacheLayout,
    TorchSplitKAttention,
)
from repro_torch.models import encdec, registry  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from _xla_strict import strict_jit  # noqa: E402
from _port_keys import as_port  # noqa: E402

ARCH = "seamless-m4t-medium"
BLOCK_K = 8
CAP = 16                     # self-attention capacity: two BLOCK_K blocks
B, S_PROMPT, NEW = 2, 6, 4
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
BACKENDS = {
    "dense-ref": lambda: DenseRefAttention(),
    "chunked-lse": lambda: ChunkedLseAttention(kv_chunk=BLOCK_K),
    "torch-splitk": lambda: TorchSplitKAttention(block_k=BLOCK_K, device="cpu"),
}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _arrays(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _case():
    """(cfg, reference cfg, reference fp32 params, the port's fp32 params,
    prompts, frames fp32)."""
    cfg, ref_cfg = get_config(ARCH).reduced(), ref_get_config(ARCH).reduced()
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          ref_encdec.init(jax.random.key(0), ref_cfg))
    port = encdec.params_from_arrays(cfg, _arrays(params), device="cpu",
                                     dtype=torch.float32)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, size=(B, S_PROMPT)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)
                                 ).astype(np.float32)
    return cfg, ref_cfg, params, port, prompts, frames


@pytest.fixture(scope="module")
def case():
    return _case()


def _batches(prompts, frames):
    return ({"tokens": jnp.asarray(prompts), "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(prompts).long(),
             "frames": torch.from_numpy(frames)})


@pytest.fixture(scope="module")
def prefilled(case):
    cfg, ref_cfg, params, port, prompts, frames = case
    ref_batch, batch = _batches(prompts, frames)
    want_logits, want_cache = strict_jit(
        lambda p, b: ref_encdec.prefill(p, b, ref_cfg, CAP,
                                        layout=RefLayout(BLOCK_K)))(
        params, ref_batch)
    logits, cache = encdec.prefill(port, batch, cfg, CAP,
                                   layout=KVCacheLayout(BLOCK_K))
    token = np.asarray(jnp.argmax(want_logits, axis=-1)).astype(np.int32)
    return want_logits, want_cache, logits, cache, token


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------


def test_config_matches_the_reference():
    port, ref = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(port) == as_port(ref)
    assert dataclasses.asdict(port.reduced()) == as_port(ref.reduced())
    assert port.param_count() == ref.param_count()
    assert 0.4e9 <= port.param_count() <= 1.6e9
    assert (port.n_encoder_layers, port.n_layers, port.frontend_tokens) == (
        12, 12, 1024)


def test_params_carry_over_exactly(case):
    cfg, _, params, port, _, _ = case
    np.testing.assert_array_equal(
        _np(port.dec_blocks[2].cross_attn.wk),
        np.asarray(params["dec_blocks"]["cross_attn"]["wk"][2]))
    np.testing.assert_array_equal(
        _np(port.enc_blocks[1].mlp.wo),
        np.asarray(params["enc_blocks"]["mlp"]["wo"][1]))
    np.testing.assert_array_equal(_np(port.ln_enc), np.asarray(params["ln_enc"]))
    n = sum(p.numel() for p in port.parameters())
    assert n == sum(a.size for a in jax.tree.leaves(params))
    assert (len(port.enc_blocks), len(port.dec_blocks)) == (
        cfg.n_encoder_layers, cfg.n_layers)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


def test_encode_matches_the_reference(case):
    cfg, ref_cfg, params, port, _, frames = case
    want = strict_jit(lambda p, f: ref_encdec.encode(p, f, ref_cfg))(
        params, jnp.asarray(frames))
    got = encdec.encode(port, torch.from_numpy(frames), cfg)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))
    # with XLA's default excess precision the reference keeps extra bits:
    # still within the bf16 tolerance
    loose = ref_encdec.encode(params, jnp.asarray(frames), ref_cfg)
    np.testing.assert_allclose(_np(got), _np(loose), **BF16_TOL)


def test_forward_logits_match(case, prefilled):
    cfg, ref_cfg, params, port, prompts, frames = case
    ref_batch, batch = _batches(prompts, frames)
    got = encdec.forward(port, batch, cfg)
    want = strict_jit(lambda p, b: ref_encdec.forward(p, b, ref_cfg))(
        params, ref_batch)
    assert got.shape == (B, S_PROMPT, cfg.padded_vocab())
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(got[:, -1:]), _np(prefilled[2]), **TOL)


def test_prefill_logits_and_caches_match(case, prefilled):
    cfg = case[0]
    want_logits, want_cache, logits, cache, _ = prefilled
    np.testing.assert_allclose(_np(logits), _np(want_logits), **TOL)
    for key in ("k", "v", "kc", "vc"):
        assert tuple(cache[key].shape) == want_cache[key].shape, key
        np.testing.assert_allclose(_np(cache[key]), _np(want_cache[key]),
                                   err_msg=key, **TOL)
    assert cache["kc"].shape[3] == cfg.frontend_tokens
    assert int(cache["length"]) == int(want_cache["length"]) == S_PROMPT
    assert int(cache["src_length"]) == int(want_cache["src_length"]) \
        == cfg.frontend_tokens


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_decode_step_logits_match_at_edge_cache_lens(case, prefilled, backend):
    """Self-attention lengths at the block edges, and cross-attention
    lengths below and at the source length (0 attends to the mean of the
    cross V over its capacity, as the reference does)."""
    cfg, ref_cfg, params, port, _, _ = case
    _, want_cache, _, cache, token = prefilled
    ref_step = strict_jit(lambda p, t, c: ref_encdec.decode_step(
        p, t, c, ref_cfg, attn_backend=RefDenseRef()))
    be = BACKENDS[backend]()
    src = cfg.frontend_tokens
    for cache_len, src_len in ((0, src), (1, 0), (BLOCK_K - 1, src - 1),
                               (BLOCK_K, 1), (BLOCK_K + 1, src), (CAP - 1, 5)):
        c = dict(want_cache, length=jnp.asarray(cache_len, jnp.int32),
                 src_length=jnp.asarray(src_len, jnp.int32))
        want, want_next = ref_step(params, jnp.asarray(token), c)
        mine = _clone(cache)
        mine["length"] = torch.tensor(cache_len, dtype=torch.int32)
        mine["src_length"] = torch.tensor(src_len, dtype=torch.int32)
        got, got_next = encdec.decode_step(port, torch.from_numpy(token).long(),
                                           mine, cfg, attn_backend=be)
        msg = f"{backend} cache_len={cache_len} src_len={src_len}"
        np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(got_next[key]), _np(want_next[key]),
                                       err_msg=msg, **TOL)
        assert torch.equal(got_next["kc"], cache["kc"])
        assert int(got_next["length"]) == cache_len + 1
        assert int(got_next["src_length"]) == src_len


def test_generate_tokens_equal_the_reference_engine(case):
    """Through both sides' split-KV backends, frames as ``extra``: identical
    greedy tokens, last-step logits within 1e-4."""
    cfg, ref_cfg, params, port, prompts, frames = case
    ref = RefEngine(ref_cfg, params=params,
                    attn_backend=PallasSplitKAttention(block_k=BLOCK_K))
    ref._prefill = strict_jit(ref.model.prefill, static_argnums=(2,))
    ref._decode = strict_jit(ref.model.decode_step)
    want = ref.generate(prompts, max_new_tokens=NEW, extra={"frames": frames})
    eng = ServingEngine(cfg, params=port, device="cpu",
                        attn_backend=TorchSplitKAttention(block_k=BLOCK_K,
                                                          device="cpu"))
    got = eng.generate(prompts, max_new_tokens=NEW, extra={"frames": frames})
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.prefill_logits, want.prefill_logits, **TOL)


def test_bf16_path_stays_near_its_own_fp32_run(case, prefilled):
    cfg, _, params, port, prompts, frames = case
    _, _, logits32, cache32, token = prefilled
    bf16 = encdec.params_from_arrays(cfg, _arrays(params), device="cpu",
                                     dtype=torch.bfloat16)
    logits, cache = encdec.prefill(bf16, _batches(prompts, frames)[1], cfg, CAP,
                                   layout=KVCacheLayout(BLOCK_K))
    assert cache["k"].dtype == cache["kc"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(logits), _np(logits32), **BF16_TOL)
    be = BACKENDS["torch-splitk"]()
    tok = torch.from_numpy(token).long()
    step, _ = encdec.decode_step(bf16, tok, cache, cfg, attn_backend=be)
    step32, _ = encdec.decode_step(port, tok, _clone(cache32), cfg,
                                   attn_backend=be)
    np.testing.assert_allclose(_np(step), _np(step32), **BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_encdec_decode_matches_forward(dtype):
    """The port of the reference's smoke test: the port's own random
    weights, frames in bf16, 9 tokens: the decode of token 8 after a prefill
    of 8 gives the forward pass's logits at 8 (2e-2, the smoke test's
    tolerance; 1e-4 in fp32)."""
    cfg = get_config(ARCH).reduced()
    model = encdec.init(torch.Generator().manual_seed(1), cfg, dtype=dtype)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal(
        (2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)).bfloat16()
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 9))).long()
    full = encdec.forward(model, {"frames": frames, "tokens": toks}, cfg)
    _, cache = encdec.prefill(model, {"frames": frames, "tokens": toks[:, :8]},
                              cfg, 16)
    dec, _ = encdec.decode_step(model, toks[:, 8:9], cache, cfg,
                                attn_backend=BACKENDS["torch-splitk"]())
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, 8]), rtol=tol,
                               atol=tol)


def test_registry_specs_give_the_port_layout(case):
    cfg, ref_cfg = case[0], case[1]
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("s", CAP, B, kind)
        want = ref_registry.input_specs(ref_cfg, shape)
        got = registry.input_specs(cfg, shape)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())
    shape = ShapeConfig("d", CAP, B, "decode")
    want = ref_registry.cache_specs(ref_cfg, shape)
    got = registry.cache_specs(cfg, shape)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    concrete = registry.cache_specs(cfg, shape, abstract=False)
    assert int(concrete["src_length"]) == cfg.frontend_tokens
    api = registry.get_model(cfg, attn_backend=BACKENDS["dense-ref"]())
    tok = registry.input_specs(cfg, shape, abstract=False)["token"].long()
    logits, _ = api.decode_step(case[3], tok, concrete)
    assert logits.shape == (B, 1, cfg.padded_vocab())
    assert api.cache_seq_axes(concrete) == {
        "k": -2, "v": -2, "kc": None, "vc": None, "length": None,
        "src_length": None}
