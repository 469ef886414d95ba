"""The port's hybrid family (``repro_torch.models.hybrid``, zamba2-7b)
against the JAX package's, on the CPU, at ``zamba2-7b.reduced()`` (7
layers, the shared block every 3: two groups and a tail of one, so 3
sites) and at a 6-layer cut of it (two groups, no tail, 2 sites).

Both sides hold the same weights: the reference's ``hybrid.init`` params
cast to fp32 (this image's CPU jax cannot run the bf16 LM path) and
carried over with ``hybrid.params_from_arrays``.  The port keeps its own
cache layout (``{"k", "v": [sites, ...], "conv", "ssm": [layers, ...]}``,
the batch axis second); the reference's tree (``kv``, ``states``,
``tail_kv``, ``tail_state``) is mapped onto it to compare.  Logits and
caches are held to 1e-4, the reference's fp32 model tolerance (the two
sides sum in different orders); greedy tokens must be identical to the
reference's engine; the port's bf16 path stays within 3e-2 of its own
fp32 run.
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
from repro.models import hybrid as ref_hybrid  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.serving.engine import ServingEngine as RefEngine  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.core.backends import (  # noqa: E402
    ChunkedLseAttention,
    DenseRefAttention,
    KVCacheLayout,
    TorchSplitKAttention,
)
from repro_torch.models import hybrid, registry  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from _port_keys import as_port  # noqa: E402

ARCH = "zamba2-7b"
CASES = {"tail": 7, "no_tail": 6}       # n_layers; shared block every 3
BLOCK_K = 8
CAP = 16                     # decode cache capacity: two BLOCK_K blocks
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
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), tree)


@functools.lru_cache(maxsize=None)
def _case(n_layers):
    """(cfg, reference cfg, reference fp32 params, the port's fp32 params,
    prompts)."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=n_layers)
    ref_cfg = dataclasses.replace(ref_get_config(ARCH).reduced(),
                                  n_layers=n_layers)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          ref_hybrid.init(jax.random.key(0), ref_cfg))
    port = hybrid.params_from_arrays(cfg, _arrays(params), device="cpu",
                                     dtype=torch.float32)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, size=(B, S_PROMPT)).astype(np.int32)
    return cfg, ref_cfg, params, port, prompts


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return _case(CASES[request.param])


def to_port_layout(cache, cfg):
    """The reference's hybrid cache tree in the port's layout, as numpy."""
    n_full, g, tail = ref_hybrid._group_sizes(cfg)
    conv, ssm = cache["states"]

    def layers(group_leaf, tail_leaf):
        a = np.asarray(group_leaf, np.float32)
        a = a.reshape((n_full * g,) + a.shape[2:])
        if tail:
            a = np.concatenate([a, np.asarray(tail_leaf, np.float32)])
        return a

    def sites(i):
        a = np.asarray(cache["kv"][i], np.float32)
        if tail:
            a = np.concatenate([a, np.asarray(cache["tail_kv"][i], np.float32)[None]])
        return a

    ts = cache["tail_state"]
    return {"k": sites(0), "v": sites(1),
            "conv": {k: layers(conv[k], ts[0][k] if tail else None)
                     for k in ("x", "B", "C")},
            "ssm": layers(ssm, ts[1] if tail else None)}


def assert_cache_close(got, want, msg=""):
    for key in ("k", "v", "ssm"):
        assert tuple(got[key].shape) == want[key].shape, (key, msg)
        np.testing.assert_allclose(_np(got[key]), want[key], err_msg=f"{key} {msg}",
                                   **TOL)
    for key in ("x", "B", "C"):
        np.testing.assert_allclose(_np(got["conv"][key]), want["conv"][key],
                                   err_msg=f"conv {key} {msg}", **TOL)


@pytest.fixture(scope="module")
def prefilled(case):
    cfg, ref_cfg, params, port, prompts = case
    want_logits, want_cache = ref_hybrid.prefill(
        params, jnp.asarray(prompts), ref_cfg, CAP, layout=RefLayout(BLOCK_K))
    logits, cache = hybrid.prefill(port, torch.from_numpy(prompts).long(), cfg,
                                   CAP, layout=KVCacheLayout(BLOCK_K))
    token = np.asarray(jnp.argmax(want_logits, axis=-1)).astype(np.int32)
    return want_logits, want_cache, logits, cache, token


def _clone(cache):
    return {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict)
                else v.clone()) for k, v in cache.items()}


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------


def test_config_matches_the_reference():
    port, ref = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(port) == as_port(ref)
    assert dataclasses.asdict(port.reduced()) == as_port(ref.reduced())
    assert port.param_count() == ref.param_count()
    assert 6.0e9 <= port.param_count() <= 7.5e9
    assert (port.d_head, port.n_heads, port.n_kv_heads) == (112, 32, 32)
    assert hybrid.n_shared_sites(port) == ref_hybrid.n_shared_sites(ref) == 14
    assert hybrid.site_sizes(port) == (6,) * 13 + (3,)


def test_params_carry_over_exactly(case):
    cfg, _, params, port, _ = case
    n_full, g, tail = ref_hybrid._group_sizes(cfg)
    np.testing.assert_array_equal(_np(port.shared.attn.wq),
                                  np.asarray(params["shared"]["attn"]["wq"]))
    assert tuple(port.shared.attn.wq.shape) == (2 * cfg.d_model, cfg.n_heads,
                                                cfg.d_head)
    assert tuple(port.shared.mlp.wo.shape) == (cfg.d_ff, cfg.d_model)
    np.testing.assert_array_equal(_np(port.blocks[g + 1].in_x),
                                  np.asarray(params["groups"]["in_x"][1, 1]))
    if tail:
        np.testing.assert_array_equal(_np(port.blocks[-1].out_proj),
                                      np.asarray(params["tail"]["out_proj"][-1]))
    assert port.blocks[0].A_log.dtype == torch.float32
    n = sum(p.numel() for p in port.parameters())
    assert n == sum(a.size for a in jax.tree.leaves(params))


def test_init_draws_every_leaf():
    cfg = get_config(ARCH).reduced()
    model = hybrid.init(torch.Generator().manual_seed(0), cfg)
    assert model.embed.dtype == torch.bfloat16
    assert bool((model.shared.ln_attn == 1).all())
    assert abs(model.shared.attn.wq.float().std().item()
               - (2 * cfg.d_model) ** -0.5) < 0.01
    for p in model.parameters():
        assert bool(torch.isfinite(p.float()).all())


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


def test_forward_logits_match(case, prefilled):
    cfg, ref_cfg, params, port, prompts = case
    got = hybrid.forward(port, torch.from_numpy(prompts).long(), cfg)
    want = ref_hybrid.forward(params, jnp.asarray(prompts), ref_cfg)
    assert got.shape == (B, S_PROMPT, cfg.padded_vocab())
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(got[:, -1:]), _np(prefilled[2]), **TOL)


def test_prefill_logits_and_cache_match(case, prefilled):
    cfg = case[0]
    want_logits, want_cache, logits, cache, _ = prefilled
    np.testing.assert_allclose(_np(logits), _np(want_logits), **TOL)
    assert cache["k"].shape == (hybrid.n_shared_sites(cfg), B, cfg.n_kv_heads,
                                CAP, cfg.d_head)
    assert cache["ssm"].dtype == torch.float32
    assert_cache_close(cache, to_port_layout(want_cache, cfg))
    assert int(cache["length"]) == int(want_cache["length"]) == S_PROMPT
    assert cache["length"].dtype == torch.int32


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_decode_step_logits_match_at_edge_cache_lens(case, prefilled, backend):
    cfg, ref_cfg, params, port, _ = case
    _, want_cache, _, cache, token = prefilled
    ref_step = jax.jit(lambda p, t, c: ref_hybrid.decode_step(
        p, t, c, ref_cfg, attn_backend=RefDenseRef()))
    be = BACKENDS[backend]()
    for cache_len in (0, 1, BLOCK_K - 1, BLOCK_K, BLOCK_K + 1, CAP - 1):
        c = dict(want_cache, length=jnp.asarray(cache_len, jnp.int32))
        want, want_next = ref_step(params, jnp.asarray(token), c)
        mine = _clone(cache)
        mine["length"] = torch.tensor(cache_len, dtype=torch.int32)
        got, got_next = hybrid.decode_step(port, torch.from_numpy(token).long(),
                                           mine, cfg, attn_backend=be)
        msg = f"{cfg.n_layers} layers/{backend} cache_len={cache_len}"
        np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **TOL)
        assert_cache_close(got_next, to_port_layout(want_next, cfg), msg)
        assert int(got_next["length"]) == cache_len + 1


def test_generate_tokens_equal_the_reference_engine(case):
    """Through both sides' split-KV backends: identical greedy tokens,
    last-step logits within 1e-4."""
    cfg, ref_cfg, params, port, prompts = case
    want = RefEngine(ref_cfg, params=params,
                     attn_backend=PallasSplitKAttention(block_k=BLOCK_K)
                     ).generate(prompts, max_new_tokens=NEW)
    eng = ServingEngine(cfg, params=port, device="cpu",
                        attn_backend=TorchSplitKAttention(block_k=BLOCK_K,
                                                          device="cpu"))
    got = eng.generate(prompts, max_new_tokens=NEW)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.prefill_logits, want.prefill_logits, **TOL)


def test_bf16_path_stays_near_its_own_fp32_run(case, prefilled):
    """bf16 params and KV cache (the SSM state stays fp32) against the
    port's fp32 run: prefill and first decode-step logits within 3e-2."""
    cfg, _, params, port, prompts = case
    _, _, logits32, cache32, token = prefilled
    bf16 = hybrid.params_from_arrays(cfg, _arrays(params), device="cpu",
                                     dtype=torch.bfloat16)
    logits, cache = hybrid.prefill(bf16, torch.from_numpy(prompts).long(), cfg,
                                   CAP, layout=KVCacheLayout(BLOCK_K))
    assert cache["k"].dtype == torch.bfloat16
    assert cache["ssm"].dtype == torch.float32
    np.testing.assert_allclose(_np(logits), _np(logits32), **BF16_TOL)
    be = BACKENDS["torch-splitk"]()
    tok = torch.from_numpy(token).long()
    step, _ = hybrid.decode_step(bf16, tok, cache, cfg, attn_backend=be)
    step32, _ = hybrid.decode_step(port, tok, _clone(cache32), cfg,
                                   attn_backend=be)
    np.testing.assert_allclose(_np(step), _np(step32), **BF16_TOL)


def test_decode_matches_teacher_forcing(case):
    """The port of ``tests/test_models_smoke.py``'s decode check: prefill on
    a prompt, then decode the next prompt tokens; each step's logits equal
    the forward pass's at that position (1e-4)."""
    cfg, _, _, port, prompts = case
    tokens = torch.from_numpy(prompts).long()
    full = hybrid.forward(port, tokens, cfg)
    _, cache = hybrid.prefill(port, tokens[:, :3], cfg, CAP,
                              layout=KVCacheLayout(BLOCK_K))
    be = BACKENDS["torch-splitk"]()
    for t in range(3, S_PROMPT):
        logits, cache = hybrid.decode_step(port, tokens[:, t:t + 1], cache, cfg,
                                           attn_backend=be)
        np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, t]), **TOL)


def test_registry_specs_give_the_port_layout(case):
    """``input_specs`` / ``cache_specs``: the reference's shapes for the
    inputs, the port's own layout for the cache (meta tensors, or zeros);
    the cache decodes through the registry's model."""
    cfg, ref_cfg = case[0], case[1]
    shape = ShapeConfig("d", CAP, B, "decode")
    spec = registry.cache_specs(cfg, shape)
    assert spec["k"].device.type == "meta"
    assert spec["k"].shape == (hybrid.n_shared_sites(cfg), B, cfg.n_kv_heads,
                               CAP, cfg.d_head)
    assert spec["ssm"].shape == (cfg.n_layers, B, cfg.ssm_heads,
                                 cfg.ssm_head_dim, cfg.ssm_state)
    ref_inputs = ref_registry.input_specs(ref_cfg, shape)
    got = registry.input_specs(cfg, shape, abstract=False)
    assert tuple(got["token"].shape) == ref_inputs["token"].shape
    api = registry.get_model(cfg, attn_backend=BACKENDS["dense-ref"]())
    concrete = registry.cache_specs(cfg, shape, abstract=False)
    logits, nxt = api.decode_step(case[3], got["token"].long(), concrete)
    assert logits.shape == (B, 1, cfg.padded_vocab())
    assert int(nxt["length"]) == CAP
    assert api.cache_seq_axes(concrete) == {
        "k": -2, "v": -2, "conv": {"x": None, "B": None, "C": None},
        "ssm": None, "length": None}
