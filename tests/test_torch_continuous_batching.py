"""The port's continuous batching (``repro_torch.serving.scheduler`` over
``serving.kv_pool``) against the JAX package's, on the CPU, at the
``reduced()`` sizes of internlm2-1.8b (dense), deepseek-moe-16b (moe),
mamba2-370m (ssm), zamba2-7b (hybrid), seamless-m4t-medium (encdec) and
internvl2-2b (vlm): the scheduler, its pool and the per-row decode.

The differential streams (a request in a mixed stream bit for bit itself
served alone, within 1e-4 of the port's ``generate`` at B = 1 and of the
reference's ``RequestScheduler``, for every backend, arrival order and the
two-wave page-reuse stream) are in ``tests/test_torch_cb_*.py``, one file
a family (two for the hybrid), over ``tests/_torch_cb_common.py``.

Here: the scheduler's slot-step saving over padded static batching, the
up-front oversize check, the step's inputs written in place, vacant slots
past the capacity, the device, graph and mesh options (the sequence-sharded
step's own tests are ``tests/test_torch_sharded_*.py``), the serving plan
against the reference's; the allocator's random interleavings (run beside
the reference's allocator on the same seeds), freed pages never read by a
live request, the pool's block-table round trips, the cache classification against the reference's ``seq_axis_tree``
key by key, the decode backends with one cache length per batch row (bit
for bit the per-row calls, and within 1e-5 of the reference's Pallas
kernel under ``jax.vmap`` in interpret mode), and every family's
``decode_step`` with ``[B]`` lengths against B = 1 steps (1e-4).  The CUDA
graph of the step is checked on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.kernels.decode_attention import ops as ref_decode_ops  # noqa: E402
from repro.models.registry import cache_specs  # noqa: E402
from repro.models.registry import get_model as ref_get_model  # noqa: E402
from repro.serving import kv_pool as ref_kv_pool  # noqa: E402
from repro.serving import router as ref_router  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.backends import (  # noqa: E402
    ChunkedLseAttention,
    DenseRefAttention,
    KVCacheLayout,
    TorchSplitKAttention,
)
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serving import router  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.kv_pool import (  # noqa: E402
    RESERVED_BLOCKS,
    SINK_BLOCK,
    BlockAllocator,
    KVBlockPool,
    PoolExhausted,
    split_cache,
)
from repro_torch.serving.scheduler import Request, RequestScheduler  # noqa: E402
from _torch_cb_common import (  # noqa: E402
    BLOCK_K,
    EXTRA_KEY,
    FAMILIES,
    KERNEL_TOL,
    NUM_SLOTS,
    TOL,
    _family,
    _stream_capacity,
)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    return _family(request.param)


def _dense_engine():
    cfg = get_config("internlm2-1.8b").reduced()
    return cfg, ServingEngine(cfg, device="cpu", attn_backend=TorchSplitKAttention(
        block_k=BLOCK_K, device="cpu"))


class TestScheduler:
    def test_ragged_stream_beats_padded_static_batching(self):
        """On a ragged stream continuous batching spends fewer slot-steps
        than padded static batches of the same width (every slot of a
        static batch decodes until the batch's longest budget)."""
        cfg, eng = _dense_engine()
        rng = np.random.default_rng(11)
        budgets = [1, 8, 1, 8, 1, 8]
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                   (4,)).astype(np.int32),
                        max_new_tokens=b) for i, b in enumerate(budgets)]
        cap = _stream_capacity(eng, reqs)
        sched = RequestScheduler(eng.model, eng.params,
                                 num_slots=NUM_SLOTS, slot_capacity=cap,
                                 layout=eng.cache_layout(cap), device="cpu")
        sched.run(reqs)
        continuous = sched.steps_run * NUM_SLOTS
        static = sum(max(budgets[i:i + NUM_SLOTS]) * NUM_SLOTS
                     for i in range(0, len(budgets), NUM_SLOTS))
        assert sched.tokens_emitted == sum(budgets)
        assert continuous < static, (continuous, static)

    def test_oversized_request_rejected_up_front(self):
        cfg, eng = _dense_engine()
        layout = eng.cache_layout(8)
        sched = RequestScheduler(eng.model, eng.params, num_slots=2,
                                 slot_capacity=layout.padded_len(8),
                                 layout=layout, device="cpu")
        big = Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                      max_new_tokens=64)
        with pytest.raises(ValueError, match="slot_capacity"):
            sched.run([big])
        assert sched.steps_run == 0

    def test_admission_and_retirement_write_the_step_inputs_in_place(self):
        """Nine requests churning through three slots: the step's inputs
        and outputs (tokens, tables, mask, logits, slot state, pages) stay
        the same tensors, as a captured graph needs; on the CPU nothing is
        captured, and every page comes back."""
        cfg, eng = _dense_engine()
        rng = np.random.default_rng(3)
        reqs = [Request(rid=i, prompt=rng.integers(
                    0, cfg.vocab_size, (int(rng.integers(2, 8)),)).astype(np.int32),
                    max_new_tokens=int(rng.integers(1, 6)),
                    arrival=int(rng.integers(0, 6))) for i in range(9)]
        cap = _stream_capacity(eng, reqs)
        sched = RequestScheduler(eng.model, eng.params, num_slots=3,
                                 slot_capacity=cap,
                                 layout=eng.cache_layout(cap), device="cpu")

        def ptrs():
            ts = [sched._tokens, sched._tables_dev, sched._active_dev,
                  sched._logits, sched._state["length"], sched.pool.buffers["k"],
                  sched.pool.buffers["v"]]
            return [t.data_ptr() for t in ts]

        before = ptrs()
        before_launches = dict(decode_ops.LAUNCHES)
        res = sched.run(reqs)
        assert len(res) == 9 and sorted(r.rid for r in res) == list(range(9))
        assert ptrs() == before
        assert sched.graph is False and sched.captures == 0
        assert sched.pool.allocator.live_blocks == 0
        assert sched.tokens_emitted == sum(r.max_new_tokens for r in reqs)
        assert decode_ops.LAUNCHES == before_launches  # the CPU launches none

    def test_a_slot_idling_past_the_capacity_stays_in_bounds(self):
        """Requests one after another through three slots: the two slots
        that stay vacant run the (discarded) step far past the capacity,
        whose every index is clipped, and each request is bit for bit
        itself served alone."""
        cfg, eng = _dense_engine()
        rng = np.random.default_rng(4)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (5,)),
                        max_new_tokens=7, arrival=8 * i) for i in range(4)]
        cap = _stream_capacity(eng, reqs)
        sched = RequestScheduler(eng.model, eng.params, num_slots=3,
                                 slot_capacity=cap,
                                 layout=eng.cache_layout(cap), device="cpu")
        got = sched.run(reqs)
        assert int(sched._state["length"].max()) > cap
        for res in got:
            alone = sched.run([dataclasses.replace(reqs[res.rid], arrival=0)])[0]
            np.testing.assert_array_equal(res.tokens, alone.tokens)
            assert np.array_equal(res.final_logits, alone.final_logits)

    def test_devices_graph_flag_and_mesh(self, monkeypatch):
        cfg, eng = _dense_engine()
        with pytest.raises(ValueError, match="CUDA graph"):
            RequestScheduler(eng.model, eng.params, 2, 8, device="cpu",
                             graph=True)
        # the sequence-sharded step over a mesh of two CPU entries: one
        # request's tokens as the unsharded step's, and at one shard its
        # logits bit for bit
        req = [Request(0, np.arange(5), 3)]
        plain = eng.generate_stream(req, max_request_len=16)[0]
        for d in (1, 2):
            sharded = eng.generate_stream(
                req, max_request_len=16, axis_name="seq",
                mesh=make_mesh((d,), ("seq",), ["cpu"] * d))[0]
            np.testing.assert_array_equal(sharded.tokens, plain.tokens)
            if d == 1:
                assert np.array_equal(sharded.final_logits, plain.final_logits)
        # a family without a frontend ignores a request's extra inputs, as
        # the reference's dense model does
        plain, framed = (eng.generate_stream([Request(0, np.arange(3), 2,
                                                      extra=extra)])[0]
                         for extra in (None, {"frames": np.zeros(1)}))
        np.testing.assert_array_equal(plain.tokens, framed.tokens)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA device"):
            RequestScheduler(eng.model, eng.params, 2, 8)

    def test_serving_plan_matches_the_reference(self):
        for arch in ("internlm2-1.8b", "mamba2-370m"):
            cfg, ref_cfg = get_config(arch), ref_get_config(arch)
            for n, (plat, ref_plat) in ((576, ("cuda", "tpu")), (576, ("cpu", "cpu")),
                                        (9000, ("cpu", "cpu")), (20, ("cuda", "tpu"))):
                got = router.route_serving_plan(cfg, n, num_slots=8, platform=plat)
                want = ref_router.route_serving_plan(ref_cfg, n, num_slots=8,
                                                     platform=ref_plat)
                assert (got.slot_capacity, got.num_blocks, got.num_slots) == (
                    want.slot_capacity, want.num_blocks, want.num_slots)
                assert got.layout.block_k == want.layout.block_k
        plan = router.route_serving_plan(get_config("internlm2-1.8b"), 576,
                                         num_slots=8, platform="cuda")
        assert plan.decode.attn_backend == "torch-splitk"
        assert (plan.slot_capacity, plan.num_blocks) == (640, 2 + 8 * 5)


# ---------------------------------------------------------------------------
# BlockAllocator / KVBlockPool properties
# ---------------------------------------------------------------------------


class TestBlockAllocatorProperties:
    @settings(max_examples=20, deadline=None)
    @given(seed=st.integers(min_value=0, max_value=99999),
           num_blocks=st.integers(min_value=3, max_value=64))
    def test_random_interleavings_keep_invariants(self, seed, num_blocks):
        """Random admit/retire interleavings, run on the port's allocator
        and the reference's side by side: the same pages handed out, a live
        page never handed out again, frees reject non-live pages, and the
        pool returns to fully free once every request retires."""
        rng = np.random.default_rng(seed)
        alloc = BlockAllocator(num_blocks)
        ref = ref_kv_pool.BlockAllocator(num_blocks)
        total_free = alloc.free_blocks
        live = {}
        ever = set()
        for step in range(40):
            if live and rng.random() < 0.45:
                rid = list(live)[int(rng.integers(len(live)))]
                pages = live.pop(rid)
                alloc.free(pages)
                ref.free(pages)
            else:
                n = int(rng.integers(1, 4))
                if n > alloc.free_blocks:
                    with pytest.raises(PoolExhausted):
                        alloc.alloc(n)
                    continue
                ids = alloc.alloc(n)
                assert ids == ref.alloc(n)
                flat = [b for pages in live.values() for b in pages]
                assert not set(ids) & set(flat), "double allocation"
                assert all(b >= RESERVED_BLOCKS for b in ids), \
                    "reserved page handed out"
                live[step] = ids
                ever.update(ids)
            assert alloc.free_blocks == ref.free_blocks
        for pages in live.values():
            alloc.free(pages)
        assert alloc.free_blocks == total_free
        assert alloc.live_blocks == 0
        if ever:
            with pytest.raises(ValueError):
                alloc.free([next(iter(ever))])

    def test_freed_page_never_read_by_live_request(self):
        """Inactive slots' writes land in the sink page, so a page freed
        and handed to a live request is only ever written by its owner;
        the null page is never written."""
        layout = KVCacheLayout(block_k=2)
        shape = (1, 1, 2, 8, 3)                      # [L, B, KV, S, D]
        template = {"k": torch.zeros(shape), "v": torch.zeros(shape),
                    "length": torch.zeros((), dtype=torch.int32)}
        axes = kvcache.seq_axis_tree(template)
        pool = KVBlockPool.build(template, axes, layout, num_blocks=12)
        cache = {"k": torch.arange(float(np.prod(shape))).reshape(shape) + 1.0,
                 "v": torch.zeros(shape), "length": None}
        table = pool.admit(split_cache(cache, axes)[0], 8)
        owned = torch.as_tensor(table[:4], dtype=torch.long)
        before = pool.buffers["k"][owned].clone()
        chunks = {"k": torch.full((1, 1, 2, 3), -7.0),   # [L, slots, KV, D]
                  "v": torch.full((1, 1, 2, 3), -7.0), "length": None}
        tables = torch.as_tensor(table[None], dtype=torch.long)
        pool.scatter_token(pool.buffers, chunks, pool.write_rows(
            tables, torch.tensor([5], dtype=torch.int32),
            torch.tensor([False])))
        assert torch.equal(pool.buffers["k"][owned], before)
        # position 5 is offset 1 of a page [L, 1, KV, block_k, D]
        assert bool((pool.buffers["k"][SINK_BLOCK, ..., 1, :] == -7.0).all())
        assert bool((pool.buffers["k"][0] == 0).all())   # null page


class TestBlockTableRoundTrip:
    @settings(max_examples=15, deadline=None)
    @given(seed=st.integers(min_value=0, max_value=99999),
           block_k=st.integers(min_value=1, max_value=5),
           n_blocks_req=st.integers(min_value=1, max_value=6))
    def test_admit_gather_is_exact(self, seed, block_k, n_blocks_req):
        """Admit a random cache into fragmented physical pages, gather
        through the table: the original buffer comes back bit for bit in
        the decode kernel's layout, and the table's null tail reads
        zeros.  The reference's pool, fed the same cache through the same
        allocations, gathers the same values."""
        rng = np.random.default_rng(seed)
        layout = KVCacheLayout(block_k=block_k)
        width = 6
        S_slot = width * block_k
        shape = (2, 1, 2, S_slot, 3)                 # [L, B, KV, S, D]
        template = {"k": torch.zeros(shape), "v": torch.zeros(shape),
                    "length": torch.zeros((), dtype=torch.int32)}
        axes = kvcache.seq_axis_tree(template)
        nb = RESERVED_BLOCKS + 3 * width
        pool = KVBlockPool.build(template, axes, layout, num_blocks=nb)
        ref_axes = {"k": -2, "v": -2, "length": None}
        ref_pool = ref_kv_pool.KVBlockPool.build(
            {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
             "length": jnp.zeros((), jnp.int32)}, ref_axes,
            ref_kv_pool.KVCacheLayout(block_k=block_k), num_blocks=nb)
        for _ in range(int(rng.integers(0, 4))):   # fragment the free list
            n = int(rng.integers(1, 4))
            ids = pool.allocator.alloc(n)
            assert ids == ref_pool.allocator.alloc(n)
            if rng.random() < 0.5:
                pool.allocator.free(ids)
                ref_pool.allocator.free(ids)
        arrays = {k: rng.standard_normal(shape).astype(np.float32)
                  for k in ("k", "v")}
        cache = {"k": torch.from_numpy(arrays["k"]),
                 "v": torch.from_numpy(arrays["v"]), "length": None}
        table = pool.admit(cache, n_blocks_req * block_k)
        ref_table = ref_pool.admit({**{k: jnp.asarray(a) for k, a in arrays.items()},
                                    "length": None}, n_blocks_req * block_k)
        np.testing.assert_array_equal(table, ref_table)
        got = pool.gather(pool.buffers, torch.as_tensor(table[None],
                                                        dtype=torch.long))
        want = ref_pool.gather(ref_pool.buffers, jnp.asarray(ref_table[None]))
        valid = n_blocks_req * block_k
        for leaf in ("k", "v"):
            g = got[leaf]                             # [L, slots, KV, S, D]
            assert tuple(g.shape) == (2, 1, 2, S_slot, 3)
            assert torch.equal(g[:, 0, :, :valid], cache[leaf][:, 0, :, :valid])
            assert bool((g[:, :, :, valid:] == 0).all())
            # the reference's [slots, L, 1, KV, S, D]
            np.testing.assert_array_equal(
                g.numpy(), np.moveaxis(np.asarray(want[leaf])[:, :, 0], 0, 1))

    def test_scatter_then_gather_reads_back_written_token(self):
        layout = KVCacheLayout(block_k=3)
        shape = (1, 1, 2, 9, 4)
        template = {"k": torch.zeros(shape), "v": torch.zeros(shape),
                    "length": torch.zeros((), dtype=torch.int32)}
        axes = kvcache.seq_axis_tree(template)
        pool = KVBlockPool.build(template, axes, layout, num_blocks=10)
        table = pool.admit({"k": torch.zeros(shape), "v": torch.zeros(shape),
                            "length": None}, 9)
        tables = torch.as_tensor(table[None], dtype=torch.long)
        rng = np.random.default_rng(0)
        for pos in (0, 2, 3, 8):                     # block edges + interior
            chunk = {"k": torch.from_numpy(rng.standard_normal((1, 1, 2, 4))
                                           .astype(np.float32)),
                     "v": torch.zeros((1, 1, 2, 4)), "length": None}
            p = torch.tensor([pos], dtype=torch.int32)
            pool.scatter_token(pool.buffers, chunk, pool.write_rows(
                tables, p, torch.tensor([True])))
            got = pool.gather(pool.buffers, tables)
            assert torch.equal(got["k"][:, :, :, pos], chunk["k"])
            assert torch.equal(pool.chunks_at(got, p)["k"], chunk["k"])


# ---------------------------------------------------------------------------
# cache_seq_axes classification (drives what the pool owns)
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _zero_extra(cfg):
    if cfg.family not in EXTRA_KEY:
        return {}
    return {EXTRA_KEY[cfg.family]: torch.zeros((1, cfg.frontend_tokens,
                                                cfg.d_model))}


def test_cache_seq_axes_classify_like_the_reference(family):
    """The port's cache (its mamba2 conv cache a dict of x, B and C tails,
    the reference's one leaf; the moe cache's list of KV stacks, as the
    reference's) classified leaf by leaf as the reference's
    ``seq_axis_tree`` classifies its own cache.  The hybrid cache has the
    port's own layout: the reference's classification is mapped onto it
    (its sites' ``kv`` and ``tail_kv`` to ``k``/``v``, ``states`` and
    ``tail_state`` to ``conv``/``ssm``), and the two must agree."""
    fam, cfg, ref_cfg, _, port = family
    model = get_model(cfg, attn_backend="dense-ref")
    batch = {"tokens": torch.zeros((1, 3), dtype=torch.long), **_zero_extra(cfg)}
    _, cache = model.prefill(port, batch, 8 + (cfg.frontend_tokens or 0))
    axes = model.cache_seq_axes(cache)
    ref_axes = ref_get_model(ref_cfg).cache_seq_axes(
        cache_specs(ref_cfg, ShapeConfig("smoke", 1, 8, "decode"), abstract=True))
    if fam == "hybrid":
        kv, (conv, ssm) = ref_axes["kv"], ref_axes["states"]
        assert ref_axes["tail_kv"] == kv and ref_axes["tail_state"] == (conv, ssm)
        ref_axes = {"k": kv[0], "v": kv[1], "conv": conv, "ssm": ssm,
                    "length": ref_axes["length"]}
    assert set(axes) == set(ref_axes)
    seen = []
    for path, ax in _leaves(axes):
        want = ref_axes
        for k in path:
            if not isinstance(want, (dict, list)):
                break
            want = want[k]
        assert ax == want, path
        seen.append((path, ax))
    growing = sorted(p for p, a in seen if a == -2)
    if fam in ("dense", "vlm", "hybrid", "encdec"):
        assert growing == [("k",), ("v",)]
    elif fam == "moe":
        assert growing == [("stacks", i, kv) for i in (0, 1) for kv in "kv"]
        assert len(ref_axes["stacks"]) == len(axes["stacks"]) == 2
    else:
        assert not growing and (("conv", "x"), None) in seen
    if fam == "hybrid":
        assert (("conv", "x"), None) in seen and (("ssm",), None) in seen
    if fam == "encdec":
        assert axes["kc"] is axes["vc"] is axes["src_length"] is None
    assert axes["length"] is None


# ---------------------------------------------------------------------------
# one cache length per batch row
# ---------------------------------------------------------------------------


DECODE_BACKENDS = {
    "decode_mha": lambda q, k, v, n: decode_ops.decode_mha(q, k, v, n)[0],
    "dense-ref": lambda q, k, v, n: DenseRefAttention().decode(q[:, None], k, v, n)[:, 0],
    "chunked-lse": lambda q, k, v, n: ChunkedLseAttention(kv_chunk=6).decode(
        q[:, None], k, v, n)[:, 0],
    "torch-splitk": lambda q, k, v, n: TorchSplitKAttention(
        block_k=8, device="cpu").decode(q[:, None], k, v, n)[:, 0],
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("backend", sorted(DECODE_BACKENDS))
def test_decode_backends_take_one_length_per_row(backend, dtype):
    """Lengths 0 (the mean of V over the capacity), 1, a block edge, the
    capacity and one past it (clipped): with ``[B]`` lengths every row
    equals its own call, alone at B = 1 and in the batch with its length as
    a scalar, bit for bit; in fp32 the outputs are within 1e-5 of the
    reference's Pallas kernel mapped over the rows with ``jax.vmap``."""
    B, H, KV, S, D = 5, 4, 2, 24, 16
    rng = np.random.default_rng(2)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, H, D), (B, KV, S, D), (B, KV, S, D))]
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    lens = torch.tensor([0, 1, 8, S, S + 5], dtype=torch.int32)
    call = DECODE_BACKENDS[backend]
    out = call(q, k, v, lens)
    for b in range(B):
        alone = call(q[b:b + 1].contiguous(), k[b:b + 1].contiguous(),
                     v[b:b + 1].contiguous(), lens[b:b + 1])
        assert torch.equal(out[b], alone[0]), b
        assert torch.equal(out[b], call(q, k, v, lens[b:b + 1])[b]), b
    if dtype == torch.float32:
        want = jax.vmap(lambda qq, kk, vv, n: ref_decode_ops.decode_mha(
            qq[None], kk[None], vv[None], n, block_k=8, interpret=True)[0][0])(
            *(jnp.asarray(a) for a in arrays), jnp.asarray(lens.numpy()))
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **KERNEL_TOL)


def test_decode_step_with_per_row_lengths_matches_b1_steps(family):
    """``transformer.decode_step`` (and every other family's) over three
    rows at their own lengths against each row's B = 1 step on its own
    cache: logits and the written K and V within 1e-4, ``length`` advanced
    per row (the encdec family's ``src_length`` one a row too).  The moe
    step routes each row as its own group."""
    fam, cfg, _, _, port = family
    model = get_model(cfg, attn_backend=TorchSplitKAttention(block_k=BLOCK_K,
                                                             device="cpu"))
    rng = np.random.default_rng(5)
    cap = 12
    caches, toks = [], []
    front = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (3, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    for b, n in enumerate((2, 5, 9)):
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)))
        extra = ({EXTRA_KEY[cfg.family]: front[b:b + 1]}
                 if cfg.family in EXTRA_KEY else {})
        logits, c = model.prefill(port, {"tokens": prompt, **extra},
                                  cap + (cfg.frontend_tokens or 0))
        caches.append(c)
        toks.append(logits[:, -1:].argmax(-1))
    axes = model.cache_seq_axes(caches[0])

    def stack(ax, *leaves):
        return torch.stack(leaves) if leaves[0].dim() == 0 else torch.cat(leaves, 1)

    from repro_torch.serving.kv_pool import tree_map

    batch = tree_map(stack, axes, *caches)
    F = cfg.frontend_tokens if fam == "vlm" else 0  # the image prefix
    assert batch["length"].tolist() == [2 + F, 5 + F, 9 + F]
    solo = [model.decode_step(port, t, tree_map(lambda ax, x: x.clone(), axes, c))
            for t, c in zip(toks, caches)]
    logits, new = model.decode_step(port, torch.cat(toks), batch)
    assert new["length"].tolist() == [3 + F, 6 + F, 10 + F]
    for b, (want, want_cache) in enumerate(solo):
        np.testing.assert_allclose(logits[b].numpy(), want[0].numpy(), **TOL)
        for (path, leaf), (_, wleaf) in zip(_leaves(new), _leaves(want_cache)):
            if leaf.dim() > 1:  # the lengths are one a row
                np.testing.assert_allclose(leaf[:, b].numpy(), wleaf[:, 0].numpy(),
                                           err_msg=str(path), **TOL)
