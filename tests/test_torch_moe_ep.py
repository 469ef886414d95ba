"""The port's moe expert parallelism (``models/moe.py``:
``moe_ffn_shardmap``, ``moe_ffn_dispatch``) against the JAX package's
``moe_ffn``, on the CPU.

The setup is the reference's ``tests/test_moe_ep.py``: reduced
deepseek-moe-16b (8 experts) at a capacity factor of E (no token drops, so
both dispatches compute one function), ``init_moe_ffn`` at key 0, x normal
``[4, 16, d]`` at key 1, and a ``(2, 4)`` ``("data", "model")`` mesh, here
of the CPU: EP within 2e-2 of the reference's ``moe_ffn``, the reference's
bound.  The reference's params are cast to fp32 (this image's CPU jax
rejects its bf16 x bf16 -> fp32 products).  In fp32 the shards' sum is
also held to the port's ``moe_ffn`` at 1e-5 of the largest |out|, with the
same top-k experts.  ``moe_ffn_dispatch`` takes EP exactly when the flag
is on, a shard context with a model axis is set and ``n_experts`` divides
that axis (64 experts over 3 shards take ``moe_ffn``); the model's five
call sites (prefill, decode, the two stage paths, training) route through
it; a shard's expert weights are views of the stacks.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_mesh, mesh_axes_of  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

ARCH = "deepseek-moe-16b"
REF_TOL = dict(rtol=2e-2, atol=2e-2)   # tests/test_moe_ep.py


@pytest.fixture(autouse=True)
def _no_shard_ctx():
    """Every test starts and ends without a shard context and with EP off."""
    L.set_shard_ctx()
    moe.set_moe_ep_shardmap(False)
    yield
    L.set_shard_ctx()
    moe.set_moe_ep_shardmap(False)


def _ep_on(mesh):
    ax = mesh_axes_of(mesh)
    L.set_shard_ctx(mesh, ax.dp, ax.model)
    moe.set_moe_ep_shardmap(True)


def _cfgs(**kw):
    cfg, ref_cfg = get_config(ARCH).reduced(), ref_get_config(ARCH).reduced()
    kw.setdefault("moe_capacity_factor", float(cfg.n_experts))
    return dataclasses.replace(cfg, **kw), dataclasses.replace(ref_cfg, **kw)


def _port_ffn(cfg, tree) -> moe.MoeFfn:
    p = moe.MoeFfn(cfg, dtype=torch.float32)
    with torch.no_grad():
        for name in ("router", "w_gate", "w_up", "w_down"):
            getattr(p, name).copy_(torch.from_numpy(np.array(tree[name])))
        for name, t in p.shared.named_parameters():
            t.copy_(torch.from_numpy(np.array(tree["shared"][name])))
    return p


@pytest.fixture(scope="module")
def ffn_case():
    cfg, ref_cfg = _cfgs()
    tree = jax.tree.map(lambda a: a.astype(jnp.float32),
                        ref_moe.init_moe_ffn(jax.random.key(0), ref_cfg))
    x = jax.random.normal(jax.random.key(1), (4, 16, cfg.d_model), jnp.float32)
    want, _ = ref_moe.moe_ffn(tree, x, ref_cfg)
    return cfg, _port_ffn(cfg, tree), torch.from_numpy(np.array(x)), \
        np.asarray(want, np.float32)


def test_mesh_ep_matches_the_reference_moe_ffn(ffn_case):
    cfg, p, x, want = ffn_case
    _ep_on(make_mesh((2, 4), ("data", "model"), ["cpu"] * 8))
    got, metrics = moe.moe_ffn_dispatch(p, x, cfg)
    np.testing.assert_allclose(got.numpy(), want, **REF_TOL)
    assert float(metrics["drop_frac"]) == 0.0
    assert torch.isfinite(metrics["lb_loss"])


@pytest.mark.parametrize("shape", [(1, 4), (2, 4), (1, 2), (1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ep_fp32_matches_the_port_moe_ffn(ffn_case, shape, monkeypatch):
    """fp32 through both: the shards' sum within 1e-5 of the largest |out|
    of ``moe_ffn`` (the same terms, summed shard by shard), every shard
    routing each token to ``moe_ffn``'s experts, and the same
    load-balancing loss."""
    cfg, p, x, _ = ffn_case
    routed = []
    real = moe.route_topk
    monkeypatch.setattr(moe, "route_topk",
                        lambda *a: routed.append(real(*a)[1]) or real(*a))
    want, want_m = moe.moe_ffn(p, x, cfg)
    _ep_on(make_mesh(shape, ("data", "model"), ["cpu"] * int(np.prod(shape))))
    got, got_m = moe.moe_ffn_shardmap(p, x, cfg)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert len(routed) == 1 + shape[1]
    assert all(torch.equal(ids, routed[0]) for ids in routed[1:])
    np.testing.assert_allclose(float(got_m["lb_loss"]), float(want_m["lb_loss"]),
                               rtol=1e-5)


def test_dispatch_takes_ep_exactly_under_the_reference_condition(ffn_case,
                                                                 monkeypatch):
    cfg, p, x, _ = ffn_case
    calls = []
    real = moe.moe_ffn_shardmap
    monkeypatch.setattr(moe, "moe_ffn_shardmap",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    mesh = make_mesh((1, 4), ("data", "model"), ["cpu"] * 4)
    plain, _ = moe.moe_ffn(p, x, cfg)

    def dispatched():
        out, _ = moe.moe_ffn_dispatch(p, x, cfg)
        return out

    # the flag off, with a context: moe_ffn, bit for bit
    ax = mesh_axes_of(mesh)
    L.set_shard_ctx(mesh, ax.dp, ax.model)
    assert torch.equal(dispatched(), plain) and not calls
    # the flag on, no context: moe_ffn
    L.set_shard_ctx()
    moe.set_moe_ep_shardmap(True)
    assert torch.equal(dispatched(), plain) and not calls
    # a context without a model axis: moe_ffn
    L.set_shard_ctx(make_mesh((4,), ("data",), ["cpu"] * 4), ("data",), None)
    assert torch.equal(dispatched(), plain) and not calls
    # all three: EP
    L.set_shard_ctx(mesh, ax.dp, ax.model)
    dispatched()
    assert calls == [1]


def test_64_experts_over_three_shards_take_moe_ffn(monkeypatch):
    """D 3 does not divide 64 experts: the reference's rule sends the layer
    to ``moe_ffn``, the dispatch's output is ``moe_ffn``'s bit for bit."""
    cfg, _ = _cfgs(n_experts=64, experts_per_token=6)
    g = torch.Generator().manual_seed(0)
    p = moe.MoeFfn(cfg, dtype=torch.float32)
    with torch.no_grad():
        for t in p.parameters():
            t.copy_(torch.randn(t.shape, generator=g) / np.sqrt(t.shape[-2]
                                                                 if t.dim() > 1 else 1))
    x = torch.randn((2, 8, cfg.d_model), generator=g)
    monkeypatch.setattr(moe, "moe_ffn_shardmap",
                        lambda *a, **k: pytest.fail("EP taken at D 3"))
    mesh = make_mesh((1, 3), ("data", "model"), ["cpu"] * 3)
    _ep_on(mesh)
    got, _ = moe.moe_ffn_dispatch(p, x, cfg)
    want, _ = moe.moe_ffn(p, x, cfg)
    assert torch.equal(got, want)


def test_shard_weights_are_views_of_the_stacks(ffn_case):
    cfg, p, _, _ = ffn_case
    E_local = cfg.n_experts // 4
    for m in range(4):
        sl = moe._expert_slice(p, m * E_local, E_local, torch.device("cpu"))
        for name, t in sl.items():
            full = getattr(p, name)
            assert t.untyped_storage().data_ptr() == full.untyped_storage().data_ptr()
            assert t.data_ptr() == full[m * E_local].data_ptr()


@pytest.fixture(scope="module")
def model_case():
    cfg, _ = _cfgs()
    api = get_model(cfg, attn_backend="dense-ref")
    params = api.init(torch.Generator().manual_seed(0)).float()
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 6)))
    return cfg, api, params, tokens


def test_every_call_site_routes_through_the_dispatch(model_case, monkeypatch):
    """prefill, decode, the two stage paths and training each call
    ``moe_ffn_dispatch`` once a moe block."""
    from repro_torch.core.partitioner import StageSpec

    cfg, api, params, tokens = model_case
    n_moe = cfg.n_layers - cfg.first_dense_layers
    calls = []
    real = moe.moe_ffn_dispatch
    monkeypatch.setattr(moe, "moe_ffn_dispatch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))

    def count(fn):
        calls.clear()
        out = fn()
        return len(calls), out

    n, (logits, cache) = count(lambda: api.prefill(params, {"tokens": tokens}, 8))
    assert n == n_moe
    n, _ = count(lambda: api.decode_step(params, logits.argmax(-1), cache))
    assert n == n_moe
    batch = {"tokens": tokens, "labels": tokens}
    n, _ = count(lambda: api.loss_fn(params, batch))
    assert n == n_moe
    half = cfg.n_layers // 2
    specs = [StageSpec(0, 0, half, True, False),
             StageSpec(1, half, cfg.n_layers, False, True)]
    sp = [moe.slice_stage_params(params, s, cfg) for s in specs]
    total = 0
    x, caches = tokens, []
    for s, p in zip(specs, sp):
        k, (x, c) = count(lambda: moe.stage_prefill(p, s, x, cfg, 8))
        total += k
        caches.append(c)
    assert total == n_moe
    total, x = 0, logits.argmax(-1)
    for s, p, c in zip(specs, sp, caches):
        k, (x, _) = count(lambda: moe.stage_decode_step(p, s, x, c, cfg,
                                                        attn_backend="dense-ref"))
        total += k
    assert total == n_moe


def test_generate_and_loss_with_ep_match_without(model_case):
    """The model with EP on over a ``(1, 4)`` mesh of the CPU: ``generate``'s
    greedy tokens equal EP off's, its logits and the training loss within
    1e-5 (the shards' fp32 sums in another order)."""
    from repro_torch.serving.engine import ServingEngine

    cfg, api, params, tokens = model_case
    eng = ServingEngine(cfg, params=params, device="cpu", attn_backend="dense-ref")
    prompts = tokens.numpy().astype(np.int32)
    off = eng.generate(prompts, 4, max_len=16)
    loss_off = api.loss_fn(params, {"tokens": tokens, "labels": tokens})
    _ep_on(make_mesh((1, 4), ("data", "model"), ["cpu"] * 4))
    on = eng.generate(prompts, 4, max_len=16)
    loss_on = api.loss_fn(params, {"tokens": tokens, "labels": tokens})
    np.testing.assert_array_equal(on.tokens, off.tokens)
    np.testing.assert_allclose(on.prefill_logits, off.prefill_logits,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss_on), float(loss_off), rtol=1e-5)
