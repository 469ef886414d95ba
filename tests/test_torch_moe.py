"""The port's moe family (``repro_torch.models.moe``) against the JAX
package's, on the CPU, at the ``reduced()`` sizes of deepseek-moe-16b and
kimi-k2-1t-a32b.

Both sides hold the same weights: the reference's ``moe.init`` params cast
to fp32 (this image's CPU jax cannot run the bf16 LM path) and carried
over with ``moe.params_from_arrays``.  The routing pieces are held to the
reference exactly (``route_topk``'s expert ids, ties included, and
``_dispatch_tables`` with drops); ``moe_ffn`` at ``dp_groups`` 1, 2 and T
to 1e-5, with its ``lb_loss`` and ``drop_frac``; the model's forward,
prefill (logits and the fp32 caches) and decode at edge cache lengths to
1e-4 with the three attention backends, at the default capacity factor of
1.25; greedy tokens identical to the reference's engine.  Also ports of
``tests/test_models_smoke.py``'s moe cases (kimi's fp32-latent teacher
forcing included), the widened ``q`` of a decode over the fp32 cache bit
for bit against an all-fp32 call, and the configs and parameter counts.
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
from repro.models import moe as ref_moe  # noqa: E402
from repro.serving.engine import ServingEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.backends import (  # noqa: E402
    ChunkedLseAttention,
    DenseRefAttention,
    KVCacheLayout,
    TorchSplitKAttention,
)
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from _port_keys import as_port  # noqa: E402

ARCHS = ["deepseek-moe-16b", "kimi-k2-1t-a32b"]
BLOCK_K = 8
CAP = 16                     # decode cache capacity: two BLOCK_K blocks
B, S_PROMPT, NEW = 2, 6, 4
TOL = dict(rtol=1e-4, atol=1e-4)
FFN_TOL = dict(rtol=1e-5, atol=1e-5)
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
def _case(arch, capacity_factor=None):
    """(cfg, reference cfg, reference fp32 params, the port's fp32 params,
    prompts)."""
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity_factor)
        ref_cfg = dataclasses.replace(ref_cfg,
                                      moe_capacity_factor=capacity_factor)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          ref_moe.init(jax.random.key(0), ref_cfg))
    port = moe.params_from_arrays(cfg, _arrays(params), device="cpu",
                                  dtype=torch.float32)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, size=(B, S_PROMPT)).astype(np.int32)
    return cfg, ref_cfg, params, port, prompts


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return _case(request.param)


@pytest.fixture(scope="module")
def prefilled(case):
    cfg, ref_cfg, params, port, prompts = case
    want_logits, want_cache = ref_moe.prefill(
        params, jnp.asarray(prompts), ref_cfg, CAP, layout=RefLayout(BLOCK_K))
    logits, cache = moe.prefill(port, torch.from_numpy(prompts).long(), cfg,
                                CAP, layout=KVCacheLayout(BLOCK_K))
    token = np.asarray(jnp.argmax(want_logits, axis=-1)).astype(np.int32)
    return want_logits, want_cache, logits, cache, token


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


def test_configs_match_the_reference():
    for arch in ARCHS:
        port, ref = get_config(arch), ref_get_config(arch)
        assert dataclasses.asdict(port) == as_port(ref)
        assert dataclasses.asdict(port.reduced()) == as_port(ref.reduced())
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
    assert 1.3e10 <= get_config("deepseek-moe-16b").param_count() <= 2.0e10
    kimi = get_config("kimi-k2-1t-a32b")
    assert 0.8e12 <= kimi.param_count() <= 1.3e12
    assert 2.0e10 <= kimi.active_param_count() <= 4.5e10


def test_params_carry_over_exactly(case):
    """Every leaf equal; the param count equals the reference's and lands
    within the reference's 15% of the analytic count (which prices the
    dense first layer as a moe one)."""
    cfg, _, params, port, _ = case
    assert port.moe_blocks[0].moe.router.dtype == torch.float32
    np.testing.assert_array_equal(
        _np(port.moe_blocks[-1].moe.w_down),
        np.asarray(params["moe_blocks"]["moe"]["w_down"][-1]))
    np.testing.assert_array_equal(
        _np(port.moe_blocks[0].moe.shared.wi_gate),
        np.asarray(params["moe_blocks"]["moe"]["shared"]["wi_gate"][0]))
    np.testing.assert_array_equal(
        _np(port.dense_blocks[0].mlp.wo),
        np.asarray(params["dense_blocks"]["mlp"]["wo"][0]))
    n = sum(p.numel() for p in port.parameters())
    assert n == sum(a.size for a in jax.tree.leaves(params))
    assert abs(n - cfg.param_count()) / cfg.param_count() < 0.15
    assert len(port.dense_blocks) == cfg.first_dense_layers
    assert len(port.moe_blocks) == cfg.n_layers - cfg.first_dense_layers


def test_init_scales_each_bank_by_its_fan_in():
    """The port's own init: an fp32 router, bf16 banks scaled by their
    fan-in (d for w_gate and w_up, f for w_down), unit norms."""
    cfg = get_config("deepseek-moe-16b").reduced()
    port = moe.init(torch.Generator().manual_seed(0), cfg)
    m = port.moe_blocks[0].moe
    assert m.router.dtype == torch.float32 and m.w_gate.dtype == torch.bfloat16
    for w in (m.w_gate, m.w_up):
        assert abs(w.float().std().item() - cfg.d_model ** -0.5) < 0.01
    assert abs(m.w_down.float().std().item() - cfg.moe_d_ff ** -0.5) < 0.01
    assert abs(m.router.std().item() - cfg.d_model ** -0.5) < 0.01
    assert bool((port.moe_blocks[0].ln_attn == 1).all())


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------


def test_route_topk_matches_lax_top_k_with_ties():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((12, 8)).astype(np.float32)
    logits[0] = 1.0                               # every expert tied
    logits[1, [2, 5, 6]] = 3.0                    # a tie across the top k
    logits[2, [1, 7]] = logits[2].max() + 1.0     # a tie at the top
    logits[3] = np.round(logits[3])               # ties, and -0.0 and +0.0
    logits[4, :4] = np.inf                        # ties at infinity
    for k in (1, 2, 3, 8):
        w, idx = moe.route_topk(torch.from_numpy(logits), k)
        want_w, want_idx = ref_moe.route_topk(jnp.asarray(logits), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_allclose(w.numpy(), np.asarray(want_w), **FFN_TOL)
        assert w.dtype == torch.float32


@pytest.mark.parametrize("E,C,A", [(8, 1, 24), (8, 3, 24), (4, 2, 5),
                                   (16, 4, 12), (8, 8, 16)])
def test_dispatch_tables_equal_the_reference(E, C, A):
    """Random expert ids, most with more assignments an expert than C (so
    entries drop), one all on one expert; in one batched call over groups
    each group's table is the reference's, exactly."""
    rng = np.random.default_rng(E * 100 + C * 10 + A)
    groups = [rng.integers(0, E, A) for _ in range(3)]
    groups.append(np.full(A, E - 1))
    e = np.stack(groups).astype(np.int32)
    table, valid = moe._dispatch_tables(torch.from_numpy(e), E, C)
    assert table.shape == (len(groups), E, C)
    for g, ids in enumerate(e):
        want_t, want_v = ref_moe._dispatch_tables(jnp.asarray(ids), E, C)
        np.testing.assert_array_equal(table[g].numpy(), np.asarray(want_t))
        np.testing.assert_array_equal(valid[g].numpy(), np.asarray(want_v))
    assert not valid.all()                        # the case drops entries


@pytest.mark.parametrize("groups", ["1", "2", "T"])
@pytest.mark.parametrize("capacity", [1.25, 0.5], ids=["cf1.25", "cf0.5"])
def test_moe_ffn_matches_the_reference(case, groups, capacity):
    cfg, ref_cfg, params, port, _ = case
    cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity)
    ref_cfg = dataclasses.replace(ref_cfg, moe_capacity_factor=capacity)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    G = {"1": 1, "2": 2, "T": 10}[groups]
    p = jax.tree.map(lambda a: a[0], params["moe_blocks"]["moe"])
    want, wm = ref_moe.moe_ffn(p, jnp.asarray(x), ref_cfg, dp_groups=G)
    got, gm = moe.moe_ffn(port.moe_blocks[0].moe, torch.from_numpy(x), cfg,
                          dp_groups=G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN_TOL)
    np.testing.assert_allclose(float(gm["lb_loss"]), float(wm["lb_loss"]),
                               **FFN_TOL)
    assert float(gm["drop_frac"]) == pytest.approx(float(wm["drop_frac"]),
                                                   abs=1e-7)
    again, _ = moe.moe_ffn(port.moe_blocks[0].moe, torch.from_numpy(x), cfg,
                           dp_groups=G)
    assert torch.equal(got, again)
    assert moe.moe_ffn(port.moe_blocks[0].moe, torch.from_numpy(x), cfg,
                       dp_groups=G, metrics=False)[1] is None


def test_moe_ffn_per_row_groups_keep_rows_apart(case):
    """With one group a row, a row's output does not depend on the other
    rows (bit for bit its value beside other rows), which is what lets the
    continuous-batching step route each slot alone."""
    cfg, _, _, port, _ = case
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 1, cfg.d_model)).astype(np.float32))
    y = x.clone()
    y[1:] = torch.from_numpy(rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32))
    blk = port.moe_blocks[0].moe
    a, _ = moe.moe_ffn(blk, x, cfg, dp_groups=4)
    b, _ = moe.moe_ffn(blk, y, cfg, dp_groups=4)
    assert torch.equal(a[0], b[0])


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


def test_forward_logits_match(case, prefilled):
    cfg, ref_cfg, params, port, prompts = case
    got, lb = moe.forward(port, torch.from_numpy(prompts).long(), cfg)
    want, want_lb = ref_moe.forward(params, jnp.asarray(prompts), ref_cfg)
    assert got.shape == (B, S_PROMPT, cfg.padded_vocab())
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(float(lb), float(want_lb), **TOL)
    np.testing.assert_allclose(_np(got[:, -1:]), _np(prefilled[2]), **TOL)


def test_prefill_logits_and_caches_match(case, prefilled):
    want_logits, want_cache, logits, cache, _ = prefilled
    np.testing.assert_allclose(_np(logits), _np(want_logits), **TOL)
    assert len(cache["stacks"]) == len(want_cache["stacks"]) == 2
    for got, want in zip(cache["stacks"], want_cache["stacks"]):
        for key in ("k", "v"):
            assert got[key].dtype == moe.DECODE_CACHE_DTYPE == torch.float32
            assert tuple(got[key].shape) == want[key].shape
            np.testing.assert_allclose(_np(got[key]), _np(want[key]), **TOL)
    assert int(cache["length"]) == int(want_cache["length"]) == S_PROMPT
    assert cache["length"].dtype == torch.int32


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_decode_step_logits_match_at_edge_cache_lens(case, prefilled, backend):
    cfg, ref_cfg, params, port, _ = case
    _, want_cache, _, cache, token = prefilled
    ref_step = jax.jit(lambda p, t, c: ref_moe.decode_step(
        p, t, c, ref_cfg, attn_backend=RefDenseRef()))
    be = BACKENDS[backend]()
    for cache_len in (0, 1, BLOCK_K - 1, BLOCK_K, BLOCK_K + 1, CAP - 1):
        c = dict(want_cache, length=jnp.asarray(cache_len, jnp.int32))
        want, want_next = ref_step(params, jnp.asarray(token), c)
        mine = {"stacks": [{k: v.clone() for k, v in s.items()}
                           for s in cache["stacks"]],
                "length": torch.tensor(cache_len, dtype=torch.int32)}
        got, got_next = moe.decode_step(port, torch.from_numpy(token).long(),
                                        mine, cfg, attn_backend=be)
        msg = f"{cfg.name}/{backend} cache_len={cache_len}"
        np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **TOL)
        for g, w in zip(got_next["stacks"], want_next["stacks"]):
            np.testing.assert_allclose(_np(g["k"]), _np(w["k"]), err_msg=msg,
                                       **TOL)
        assert int(got_next["length"]) == cache_len + 1


def test_generate_tokens_equal_the_reference_engine(case):
    """At the default capacity factor, through both sides' split-KV
    backends: identical greedy tokens, last-step logits within 1e-4."""
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
    """bf16 params over the fp32 cache against the port's fp32 run: prefill
    and first decode-step logits within 3e-2."""
    cfg, _, params, port, prompts = case
    _, _, logits32, cache32, token = prefilled
    bf16 = moe.params_from_arrays(cfg, _arrays(params), device="cpu",
                                  dtype=torch.bfloat16)
    assert bf16.moe_blocks[0].moe.router.dtype == torch.float32
    logits, cache = moe.prefill(bf16, torch.from_numpy(prompts).long(), cfg,
                                CAP, layout=KVCacheLayout(BLOCK_K))
    assert cache["stacks"][0]["k"].dtype == torch.float32
    np.testing.assert_allclose(_np(logits), _np(logits32), **BF16_TOL)
    be = BACKENDS["torch-splitk"]()
    tok = torch.from_numpy(token).long()
    step, _ = moe.decode_step(bf16, tok, cache, cfg, attn_backend=be)
    c32 = {"stacks": [{k: v.clone() for k, v in s.items()}
                      for s in cache32["stacks"]],
           "length": cache32["length"].clone()}
    step32, _ = moe.decode_step(port, tok, c32, cfg, attn_backend=be)
    np.testing.assert_allclose(_np(step), _np(step32), **BF16_TOL)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_bf16_q_over_the_fp32_cache_is_widened(backend):
    """A bf16 ``q`` over an fp32 cache: the backend widens ``q`` (exact)
    and rounds its output to bf16 once, bit for bit the all-fp32 call
    rounded; ``decode_mha`` itself still refuses mixed dtypes."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((3, 1, 4, 32)).astype(np.float32)
                         ).to(torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((3, 4, 16, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((3, 4, 16, 32)).astype(np.float32))
    lens = torch.tensor([0, 7, 16], dtype=torch.int32)
    be = BACKENDS[backend]()
    got = be.decode(q, k, v, lens)
    want = be.decode(q.float(), k, v, lens)
    assert got.dtype == torch.bfloat16 and want.dtype == torch.float32
    assert torch.equal(got, want.to(torch.bfloat16))
    with pytest.raises(TypeError, match="q is torch.bfloat16"):
        decode_ops.decode_mha(q[:, 0], k, v, lens)


# ---------------------------------------------------------------------------
# ports of tests/test_models_smoke.py's moe cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_roundtrip(arch):
    cfg = get_config(arch).reduced()
    model = get_model(cfg, attn_backend=TorchSplitKAttention(device="cpu"))
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)))
    logits, cache = model.prefill(params, {"tokens": toks}, 40)
    assert logits.shape[:2] == (2, 1) and torch.isfinite(logits).all()
    token = logits.argmax(-1)
    logits2, cache2 = model.decode_step(params, token, cache)
    assert logits2.shape == logits.shape and torch.isfinite(logits2).all()
    assert int(cache2["length"]) == int(cache["length"]) + 1
    full = model.forward(params, {"tokens": toks})
    assert full.shape == (2, 32, cfg.padded_vocab()) and torch.isfinite(full).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """Decode with the cache agrees with the full forward on the same
    prefix (capacity raised to n_experts, so that no token drops in either,
    as the reference's smoke test does), bf16 params, 2e-2."""
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.n_experts))
    model = get_model(cfg, attn_backend=TorchSplitKAttention(device="cpu"))
    params = model.init(torch.Generator().manual_seed(1))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 9)))
    full = model.forward(params, {"tokens": toks})
    _, cache = model.prefill(params, {"tokens": toks[:, :8]}, 16)
    dec, _ = model.decode_step(params, toks[:, 8:9], cache)
    np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, 8]),
                               rtol=2e-2, atol=2e-2)


def test_kimi_decode_matches_teacher_forcing_fp32_latent_cache():
    """The reference's kimi-k2 gate: with the cache at fp32
    (``DECODE_CACHE_DTYPE``), decode with the cache agrees with the
    teacher-forced forward within 2e-2; the port's prefill already emits
    fp32 caches, and on the reference's fp32-cast weights both sides'
    decode logits agree to 1e-4."""
    cfg, ref_cfg, params, port, _ = _case("kimi-k2-1t-a32b", 8.0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9))
    full, _ = moe.forward(port, torch.from_numpy(toks), cfg)
    _, cache = moe.prefill(port, torch.from_numpy(toks[:, :8]), cfg, 16,
                           layout=KVCacheLayout(BLOCK_K))
    assert all(s["k"].dtype == torch.float32 for s in cache["stacks"])
    dec, _ = moe.decode_step(port, torch.from_numpy(toks[:, 8:9]), cache, cfg,
                             attn_backend=BACKENDS["torch-splitk"]())
    np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, 8]),
                               rtol=2e-2, atol=2e-2)
    _, ref_cache = ref_moe.prefill(params, jnp.asarray(toks[:, :8], jnp.int32),
                                   ref_cfg, 16)
    want, _ = ref_moe.decode_step(params, jnp.asarray(toks[:, 8:9], jnp.int32),
                                  ref_cache, ref_cfg, attn_backend="dense-ref")
    np.testing.assert_allclose(_np(dec), _np(want), **TOL)
