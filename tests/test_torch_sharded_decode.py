"""The port's sequence-sharded decode (``models/attention.py::
sharded_decode_attend`` and ``decode_step(..., seq_shard_axes=mesh)`` of
the transformer, moe, hybrid and encdec families) against the JAX
package, on the CPU: the twin of the reference's
``tests/test_sharded_decode.py``.

The setup is the reference's: ``reduced()`` internlm2-1.8b,
deepseek-moe-16b (init key 1, capacity factor E), zamba2-7b and
seamless-m4t-medium, a batch of 2 prompts of 8 tokens from
``input_specs(seed=0)``, the cache padded to ``block_k`` 4 from a requested
capacity of 13 (16), and meshes of D = 1, 2 and 4 entries of the CPU
(``make_mesh((D,), ("seq",), [cpu] * D)``), each shard a contiguous
``[.., S / D, D]`` slice of the cache.  Both sides hold the reference's
params cast to fp32 (this image's CPU jax rejects the bf16 x bf16 -> fp32
products), and fp32 caches; the reference is compiled with XLA's excess
precision off (``_xla_strict``), as the encdec tests compile it: its
encoder's bf16 frames then round where its code says.

* **op level**: the new token written on the shard that owns its position
  (and nowhere else), ``decode_partial`` over each shard and the lse merge
  against the reference's ``combine_split_kv_stacked`` of the reference's
  partials on the same shards, and against the port's unsharded decode,
  at 1e-5, at every insert position class (the first, a block's last and
  first, the last); one position a batch row as well; bf16 at 2e-2;
* **model level**: for each backend at the ragged lengths ``(1, 3, 4, 5,
  13, 15)``, the sharded ``decode_step``'s logits against the reference's
  unsharded ``dense-ref`` ``decode_step``: 1e-4 at D 1 (and bit for bit
  the port's unsharded step with the same backend), 3e-2 at D > 1 (the
  reference's bound: the shards reorder fp32 partial sums, which can flip
  a bf16-rounded activation downstream; these fp32 models read at most
  4.0e-06 against the reference at any D);
  the cache reassembled from its shards against the unsharded step's at
  the reference's bands (1e-2 at D 1, 0.1 beyond).
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
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.core.backends import KVCacheLayout as RefLayout  # noqa: E402
from repro.core.backends import get_backend as ref_get_backend  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import encdec as ref_encdec  # noqa: E402
from repro.models import hybrid as ref_hybrid  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.models.registry import input_specs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.backends import (  # noqa: E402
    ChunkedLseAttention,
    DenseRefAttention,
    KVCacheLayout,
    TorchSplitKAttention,
)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import attention, encdec, hybrid, moe, transformer  # noqa: E402
from repro_torch.serving.kv_pool import tree_map  # noqa: E402
from _xla_strict import strict_jit  # noqa: E402

BLOCK_K = 4
CAP_REQ = 13
CAP = 16
LAYOUT = KVCacheLayout(block_k=BLOCK_K)
REF_LAYOUT = RefLayout(block_k=BLOCK_K)
D_ALL = (1, 2, 4)
LENS = (1, BLOCK_K - 1, BLOCK_K, BLOCK_K + 1, CAP_REQ, CAP - 1)
OP_TOL = dict(rtol=1e-5, atol=1e-5)
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
SHARDED_MODEL_TOL = dict(rtol=3e-2, atol=3e-2)

FAMILIES = {
    "transformer": ("internlm2-1.8b", ref_transformer, transformer),
    "moe": ("deepseek-moe-16b", ref_moe, moe),
    "hybrid": ("zamba2-7b", ref_hybrid, hybrid),
    "encdec": ("seamless-m4t-medium", ref_encdec, encdec),
}
BACKENDS = {
    "dense-ref": DenseRefAttention,
    "chunked-lse": lambda: ChunkedLseAttention(kv_chunk=3),
    "torch-splitk": lambda: TorchSplitKAttention(block_k=BLOCK_K, device="cpu"),
}


def _mesh(d):
    return make_mesh((d,), ("seq",), ["cpu"] * d)


# ---------------------------------------------------------------------------
# op level
# ---------------------------------------------------------------------------


def _op_inputs():
    rng = np.random.default_rng(0)
    B, H, KV, S, D = 2, 4, 2, CAP, 8
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (mk(B, 1, H, D), mk(B, KV, S, D), mk(B, KV, S, D),
            mk(B, KV, 1, D), mk(B, KV, 1, D))


def _shards(t: torch.Tensor, d: int):
    return [c.contiguous() for c in t.chunk(d, dim=2)]


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_sharded_attend_matches_the_reference_combine(backend):
    q, k, v, k_new, v_new = _op_inputs()
    be = BACKENDS[backend]()
    T = torch.from_numpy
    for d in D_ALL:
        sl = CAP // d
        for pos in (0, BLOCK_K - 1, BLOCK_K, CAP_REQ - 1, CAP - 1):
            ks, vs = _shards(T(k), d), _shards(T(v), d)
            got, ks, vs = attention.sharded_decode_attend(
                be, T(q), T(k_new), T(v_new), ks, vs,
                torch.tensor([pos], dtype=torch.int32), _mesh(d))
            # the token on its owner, every other position untouched
            kr = k.copy()
            kr[:, :, pos] = k_new[:, :, 0]
            vr = v.copy()
            vr[:, :, pos] = v_new[:, :, 0]
            assert torch.equal(torch.cat(ks, dim=2), T(kr))
            assert torch.equal(torch.cat(vs, dim=2), T(vr))
            # the reference's partials on the same shards, its combine
            outs, lses = [], []
            for i in range(d):
                o, lse = ref_attention.decode_attention_dense(
                    jnp.asarray(q), jnp.asarray(kr[:, :, i * sl:(i + 1) * sl]),
                    jnp.asarray(vr[:, :, i * sl:(i + 1) * sl]),
                    jnp.asarray(int(np.clip(pos + 1 - i * sl, 0, sl))),
                    return_lse=True)
                outs.append(o)
                lses.append(lse)
            want = ref_attention.combine_split_kv_stacked(jnp.stack(outs),
                                                          jnp.stack(lses))
            msg = f"{backend} d={d} pos={pos}"
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=msg, **OP_TOL)
            unsharded = be.decode(T(q), T(kr), T(vr), torch.tensor(
                [pos + 1], dtype=torch.int32))
            np.testing.assert_allclose(got.numpy(), unsharded.numpy(),
                                       err_msg=msg, **OP_TOL)
            if d == 1:
                assert torch.equal(got, unsharded.float()), msg


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_sharded_attend_with_one_position_a_row(backend):
    """Rows at their own positions (the scheduler's slots): each row's
    token on its own owner, each row's own valid prefix on every shard;
    a position past the capacity (a vacant slot) writes nowhere."""
    q, k, v, k_new, v_new = (torch.from_numpy(a) for a in _op_inputs())
    be = BACKENDS[backend]()
    for d in D_ALL:
        for rows in ((0, CAP - 1), (BLOCK_K, CAP_REQ - 1), (7, 2)):
            pos = torch.tensor(rows, dtype=torch.int32)
            ks, vs = _shards(k.clone(), d), _shards(v.clone(), d)
            got, ks, vs = attention.sharded_decode_attend(
                be, q, k_new, v_new, ks, vs, pos, _mesh(d))
            kr = k.clone()
            kr[torch.arange(2), :, pos.long()] = k_new[:, :, 0]
            vr = v.clone()
            vr[torch.arange(2), :, pos.long()] = v_new[:, :, 0]
            assert torch.equal(torch.cat(ks, dim=2), kr)
            want = be.decode(q, kr, vr, pos + 1)
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       err_msg=f"{backend} d={d} {rows}",
                                       **OP_TOL)
        ks = _shards(k.clone(), d)
        attention.sharded_decode_attend(
            be, q, k_new, v_new, ks, _shards(v.clone(), d),
            torch.tensor([3, CAP + 5], dtype=torch.int32), _mesh(d))
        kr = k.clone()
        kr[0, :, 3] = k_new[0, :, 0]
        assert torch.equal(torch.cat(ks, dim=2), kr)


def test_sharded_attend_bf16_and_the_empty_shard():
    """bf16 caches through the kernel's plain version: within 2e-2 of the
    unsharded decode.  A shard without a valid position has lse ~ -1e30
    and weight 0."""
    q, k, v, k_new, v_new = (torch.from_numpy(a) for a in _op_inputs())
    be = TorchSplitKAttention(block_k=BLOCK_K, device="cpu")
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    for d in D_ALL:
        for pos in (0, CAP_REQ - 1):
            ks, vs = _shards(bf(k), d), _shards(bf(v), d)
            got, ks, vs = attention.sharded_decode_attend(
                be, bf(q), bf(k_new), bf(v_new), ks, vs,
                torch.tensor([pos], dtype=torch.int32), _mesh(d))
            want = be.decode(bf(q), torch.cat(ks, dim=2), torch.cat(vs, dim=2),
                             torch.tensor([pos + 1], dtype=torch.int32))
            np.testing.assert_allclose(got.numpy(), want.float().numpy(),
                                       rtol=2e-2, atol=2e-2)
    _, lse = be.decode_partial(q, k[:, :, :4].contiguous(),
                               v[:, :, :4].contiguous(),
                               torch.tensor([0], dtype=torch.int32))
    assert float(lse.max()) < -1e29
    o1, l1 = be.decode_partial(q, k, v, torch.tensor([5], dtype=torch.int32))
    o0, l0 = be.decode_partial(q, k, v, torch.tensor([0], dtype=torch.int32))
    assert torch.equal(attention.combine_split_kv([o1, o0], [l1, l0]), o1)


def test_shard_bounds_and_mesh_checks():
    assert attention.seq_shard_bounds(0, 4) == (0, 0)
    assert attention.seq_shard_bounds(3, 4) == (12, 3)
    q, k, v, k_new, v_new = (torch.from_numpy(a) for a in _op_inputs())
    be = DenseRefAttention()
    with pytest.raises(ValueError, match="as many shards"):
        attention.sharded_decode_attend(be, q, k_new, v_new, _shards(k, 2),
                                        _shards(v, 2), torch.tensor([0]),
                                        _mesh(4))
    assert attention.shard_devices(_mesh(2)) == [torch.device("cpu")] * 2
    assert attention.shard_devices(["cpu"]) == [torch.device("cpu")]


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@functools.lru_cache(maxsize=None)
def _family(family):
    """(port cfg, port module, port fp32 params, the reference's decode
    function, its fp32 params, the prompt's batch)."""
    arch, ref_mod, mod = FAMILIES[family]
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    if family == "moe":
        kw = dict(moe_capacity_factor=float(cfg.n_experts))
        cfg, ref_cfg = (dataclasses.replace(cfg, **kw),
                        dataclasses.replace(ref_cfg, **kw))
    params = jax.tree.map(
        lambda a: a.astype(jnp.float32),
        ref_mod.init(jax.random.key(1 if family == "moe" else 0), ref_cfg))
    arrays = jax.tree.map(lambda a: None if a is None else np.asarray(a), params)
    port = mod.params_from_arrays(cfg, arrays, device="cpu", dtype=torch.float32)
    batch = input_specs(ref_cfg, ShapeConfig("smoke", 8, 2, "prefill"),
                        abstract=False, seed=0)
    batch = {k: np.asarray(v, np.int64 if k == "tokens" else np.float32)
             for k, v in batch.items()}
    ref_decode = strict_jit(lambda p, t, c: ref_mod.decode_step(
        p, t, c, ref_cfg, attn_backend=ref_get_backend("attention",
                                                        "dense-ref")))
    return cfg, mod, port, params, ref_cfg, ref_decode, batch


def _ref_prefill(family, params, ref_cfg, batch):
    _, ref_mod, _ = FAMILIES[family]
    b = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
         for k, v in batch.items()}
    if family == "transformer":
        return ref_mod.prefill(params, b["tokens"], ref_cfg, CAP_REQ,
                               layout=REF_LAYOUT)
    if family == "moe":
        return ref_mod.prefill(params, b["tokens"], ref_cfg, CAP_REQ, 1,
                               layout=REF_LAYOUT)
    if family == "hybrid":
        return ref_mod.prefill(params, b["tokens"], ref_cfg, CAP_REQ,
                               layout=REF_LAYOUT)
    return ref_mod.prefill(params, b, ref_cfg, CAP_REQ, layout=REF_LAYOUT)


def _port_prefill(family, mod, port, cfg, batch):
    tokens = torch.from_numpy(batch["tokens"])
    if family == "moe":
        return mod.prefill(port, tokens, cfg, CAP_REQ, 1, layout=LAYOUT)
    if family == "encdec":
        return mod.prefill(port, {"tokens": tokens,
                                  "frames": torch.from_numpy(batch["frames"])},
                           cfg, CAP_REQ, layout=LAYOUT)
    return mod.prefill(port, tokens, cfg, CAP_REQ, layout=LAYOUT)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _shard_cache(mod, cache, d):
    return tree_map(lambda ax, leaf: leaf if ax is None else
                    [c.contiguous() for c in leaf.chunk(d, dim=-2)],
                    mod.cache_seq_axes(cache), cache)


def _reassemble(mod, cache, like):
    return tree_map(lambda ax, leaf: leaf if ax is None else
                    torch.cat(leaf, dim=-2), mod.cache_seq_axes(like), cache)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family_case(request):
    family = request.param
    cfg, mod, port, params, ref_cfg, ref_decode, batch = _family(family)
    ref_logits, ref_cache = strict_jit(
        lambda p: _ref_prefill(family, p, ref_cfg, batch))(params)
    logits, cache = _port_prefill(family, mod, port, cfg, batch)
    np.testing.assert_allclose(_np(logits), np.asarray(ref_logits), **FP32_TOL)
    token = np.asarray(jnp.argmax(ref_logits, axis=-1)).astype(np.int64)
    return family, cfg, mod, port, params, ref_decode, ref_cache, cache, token


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_sharded_decode_step_matches_the_reference(family_case, backend):
    family, cfg, mod, port, params, ref_decode, ref_cache, cache, token = \
        family_case
    be = BACKENDS[backend]()
    tok = torch.from_numpy(token)
    for cache_len in LENS:
        want, _ = ref_decode(params, jnp.asarray(token, jnp.int32),
                             dict(ref_cache,
                                  length=jnp.asarray(cache_len, jnp.int32)))
        base = {**cache, "length": torch.tensor(cache_len, dtype=torch.int32)}
        plain_logits, plain_cache = mod.decode_step(
            port, tok, _clone(base), cfg, attn_backend=be, layout=LAYOUT)
        for d in D_ALL:
            msg = f"{family}/{backend} d={d} len={cache_len}"
            sharded = _shard_cache(mod, _clone(base), d)
            got, new = mod.decode_step(port, tok, sharded, cfg,
                                       attn_backend=be, layout=LAYOUT,
                                       seq_shard_axes=_mesh(d))
            assert int(new["length"]) == cache_len + 1, msg
            np.testing.assert_allclose(
                _np(got), np.asarray(want),
                err_msg=msg, **(FP32_TOL if d == 1 else SHARDED_MODEL_TOL))
            if d == 1:
                assert torch.equal(got, plain_logits), msg
            band = dict(rtol=1e-2, atol=1e-2) if d == 1 else dict(rtol=0.1,
                                                                   atol=0.1)
            for a, b in zip(_leaves(_reassemble(mod, new, base)),
                            _leaves(plain_cache)):
                np.testing.assert_allclose(_np(a), _np(b), err_msg=msg, **band)
