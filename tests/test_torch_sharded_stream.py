"""The port's sequence-sharded continuous batching
(``ServingEngine.generate_stream(mesh=..., axis_name=...)`` over
``serving/scheduler.py``'s mesh step) on the CPU: the twin of the
reference's ``tests/test_continuous_batching.py::
test_multi_device_sharded_scheduler_parity``, in this process over meshes
that repeat the CPU.

The reference's setup: ``reduced()`` internlm2-1.8b through the split-KV
backend at ``block_k`` 4 (the port's ``torch-splitk`` runs its kernel's
plain version here, the reference's Pallas kernel runs in interpret mode),
5 requests from ``default_rng(0)`` (prompts of 2-6 tokens, budgets 1-4,
arrivals 0-2), 2 slots of capacity 16, and meshes of D = 1, 2 and 4: the
same requests, the same tokens as the unsharded stream, final logits bit
for bit at D 1 (the reference allows 1e-6) and within 2e-2 beyond (the
reference's bound; the shards reorder fp32 partial sums).  Both engines
hold the reference's params cast to fp32, and the unsharded streams agree
with each other as ``tests/test_torch_cb_*`` hold them (tokens, 1e-4).
The moe (capacity factor 1.25, each slot its own token group), hybrid,
encdec and vlm families stream at D 2 and 4 the same way, each request
bit for bit itself served alone through the same sharded scheduler.
"""

import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.backends import PallasSplitKAttention  # noqa: E402
from repro.models import encdec as ref_encdec  # noqa: E402
from repro.models import hybrid as ref_hybrid  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.serving.engine import ServingEngine as RefEngine  # noqa: E402
from repro.serving.scheduler import Request as RefRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.backends import TorchSplitKAttention  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import encdec, hybrid, moe, transformer  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import Request, RequestScheduler  # noqa: E402

BLOCK_K = 4
CAP = 16                                 # 4 shards x block_k 4
SLOTS = 2
SHARDED_TOL = dict(rtol=2e-2, atol=2e-2)
FAMILIES = {"dense": ("internlm2-1.8b", ref_transformer, transformer),
            "moe": ("deepseek-moe-16b", ref_moe, moe),
            "hybrid": ("zamba2-7b", ref_hybrid, hybrid),
            "encdec": ("seamless-m4t-medium", ref_encdec, encdec),
            "vlm": ("internvl2-2b", ref_transformer, transformer)}
EXTRA_KEY = {"vlm": "extra_embeds", "encdec": "frames"}


def _mesh(d):
    return make_mesh((d,), ("seq",), ["cpu"] * d)


@functools.lru_cache(maxsize=None)
def _family(fam):
    arch, ref_mod, mod = FAMILIES[fam]
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          ref_mod.init(jax.random.key(0), ref_cfg))
    port = mod.params_from_arrays(
        cfg, jax.tree.map(lambda a: None if a is None else np.asarray(a), params),
        device="cpu", dtype=torch.float32)
    eng = ServingEngine(cfg, params=port, device="cpu",
                        attn_backend=TorchSplitKAttention(block_k=BLOCK_K,
                                                          device="cpu"))
    return cfg, ref_cfg, params, eng


def _requests(cfg, n=5):
    """The reference's stream: ``default_rng(0)``, prompts of 2-6 tokens,
    budgets of 1-4, arrivals 0-2; the family's frontend input after."""
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        (int(rng.integers(2, 7)),)).astype(np.int32),
                    max_new_tokens=int(rng.integers(1, 5)),
                    arrival=int(rng.integers(0, 3)))
            for i in range(n)]
    if cfg.family in EXTRA_KEY:
        for r in reqs:
            r.extra = {EXTRA_KEY[cfg.family]: rng.standard_normal(
                (1, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)}
    return reqs


def _capacity(cfg):
    """The smallest multiple of 4 x block_k that holds the stream (the vlm
    family's image embeddings count)."""
    need = 6 + 4 + (cfg.frontend_tokens or 0)
    return -(-need // CAP) * CAP


def _by_rid(results):
    return {r.rid: r for r in results}


def test_dense_stream_over_meshes_matches_the_unsharded_stream():
    cfg, ref_cfg, params, eng = _family("dense")
    reqs = _requests(cfg)
    ref = _by_rid(eng.generate_stream(list(reqs), num_slots=SLOTS,
                                      max_request_len=CAP))
    ref_eng = RefEngine(ref_cfg, params=params,
                        attn_backend=PallasSplitKAttention(block_k=BLOCK_K))
    want = _by_rid(ref_eng.generate_stream(
        [RefRequest(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                    arrival=r.arrival) for r in reqs],
        num_slots=SLOTS, max_request_len=CAP))
    assert sorted(want) == sorted(ref)
    for rid, r in ref.items():
        np.testing.assert_array_equal(r.tokens, want[rid].tokens)
        np.testing.assert_allclose(r.final_logits, want[rid].final_logits,
                                   rtol=1e-4, atol=1e-4)
    for d in (1, 2, 4):
        got = eng.generate_stream(list(reqs), num_slots=SLOTS,
                                  max_request_len=CAP, mesh=_mesh(d),
                                  axis_name="seq")
        assert sorted(r.rid for r in got) == sorted(ref)
        for r in got:
            msg = f"d={d} rid={r.rid}"
            np.testing.assert_array_equal(r.tokens, ref[r.rid].tokens,
                                          err_msg=msg)
            if d == 1:
                assert np.array_equal(r.final_logits, ref[r.rid].final_logits), msg
            else:
                np.testing.assert_allclose(r.final_logits,
                                           ref[r.rid].final_logits,
                                           err_msg=msg, **SHARDED_TOL)
            np.testing.assert_allclose(r.final_logits, want[r.rid].final_logits,
                                       err_msg=msg, **SHARDED_TOL)


@pytest.mark.parametrize("fam", ["moe", "hybrid", "encdec", "vlm"])
def test_family_streams_over_meshes(fam):
    cfg, _, _, eng = _family(fam)
    reqs = _requests(cfg)
    cap = _capacity(cfg)
    ref = _by_rid(eng.generate_stream(list(reqs), num_slots=SLOTS,
                                      max_request_len=cap))
    for d in (2, 4):
        sched = RequestScheduler(eng.model, eng.params, num_slots=SLOTS,
                                 slot_capacity=cap,
                                 layout=eng.cache_layout(cap), device="cpu",
                                 mesh=_mesh(d))
        got = sched.run(list(reqs))
        assert sched.pool.allocator.live_blocks == 0
        assert sorted(r.rid for r in got) == sorted(ref)
        for r in got:
            msg = f"{fam} d={d} rid={r.rid}"
            np.testing.assert_array_equal(r.tokens, ref[r.rid].tokens,
                                          err_msg=msg)
            np.testing.assert_allclose(r.final_logits, ref[r.rid].final_logits,
                                       err_msg=msg, **SHARDED_TOL)
            alone = sched.run([Request(rid=r.rid, prompt=reqs[r.rid].prompt,
                                       max_new_tokens=reqs[r.rid].max_new_tokens,
                                       extra=reqs[r.rid].extra)])[0]
            np.testing.assert_array_equal(r.tokens, alone.tokens, err_msg=msg)
            assert np.array_equal(r.final_logits, alone.final_logits), msg


def test_mesh_step_checks():
    cfg, _, _, eng = _family("dense")
    # the capacity must split into D whole block_k blocks: 16 = 4 x 4, but
    # not into 8 shards, nor 12 into 4 (it never pads)
    with pytest.raises(ValueError, match="8 sequence shards of whole block_k=4"):
        RequestScheduler(eng.model, eng.params, SLOTS, CAP,
                         layout=eng.cache_layout(CAP), device="cpu",
                         mesh=_mesh(8))
    with pytest.raises(ValueError, match="multiple of 16"):
        eng.generate_stream(_requests(cfg, 2), max_request_len=12,
                            mesh=_mesh(4))
    # the shard list is the mesh's devices along the named axis
    grid = make_mesh((2, 2), ("data", "seq"), ["cpu"] * 4)
    sched = RequestScheduler(eng.model, eng.params, SLOTS, CAP,
                             layout=eng.cache_layout(CAP), device="cpu",
                             mesh=grid, axis_name="seq")
    assert sched._seq_mesh.flat() == [torch.device("cpu")] * 2
    assert sched.graph is False
    # a family without a growing KV cache has nothing to shard
    ssm = ServingEngine(get_config("mamba2-370m").reduced(), device="cpu")
    with pytest.raises(ValueError, match="no growing KV"):
        ssm.generate_stream(_requests(ssm.cfg, 1), max_request_len=CAP,
                            mesh=_mesh(2))


@pytest.mark.parametrize("fam", ["dense", "moe"])
def test_shard_major_gather_is_the_gather_split(fam):
    """``KVBlockPool.gather(..., shards=D)`` holds the unsharded gather's
    values, shard ``d`` its positions ``[d · S / D, (d + 1) · S / D)``, each
    shard one contiguous block; ``chunks_at`` over the shard lists reads
    what it reads over the whole gathered cache, positions past the
    capacity clipped."""
    from repro_torch.serving.kv_pool import tree_map

    cfg, _, _, eng = _family(fam)
    sched = RequestScheduler(eng.model, eng.params, num_slots=3,
                             slot_capacity=CAP, layout=eng.cache_layout(CAP),
                             device="cpu", mesh=_mesh(4))
    pool = sched.pool
    g = torch.Generator().manual_seed(0)
    tree_map(lambda ax, buf: None if ax is None else buf.copy_(
        torch.randn(buf.shape, generator=g)), pool.seq_axes, pool.buffers)
    tables = torch.randint(0, pool.num_blocks, (3, pool.table_width),
                           generator=g)
    positions = torch.tensor([0, 9, CAP + 3], dtype=torch.int32)
    whole = pool.gather(pool.buffers, tables)
    for d in (1, 2, 4):
        major = pool.gather(pool.buffers, tables, shards=d)

        def check(ax, w, m):
            if ax is None:
                return
            assert m.shape[0] == d and all(s.is_contiguous() for s in m.unbind(0))
            assert torch.equal(torch.cat(m.unbind(0), dim=-2), w)

        tree_map(check, pool.seq_axes, whole, major)
        shards = tree_map(lambda ax, m: None if ax is None else list(m.unbind(0)),
                          pool.seq_axes, major)
        want = pool.chunks_at(whole, positions)
        got = pool.chunks_at(shards, positions)
        tree_map(lambda ax, a, b: None if ax is None else
                 torch.testing.assert_close(a, b, rtol=0, atol=0),
                 pool.seq_axes, got, want)
