"""The padded, bucketed prefill of the continuous-batching scheduler, on the
CPU (no JAX): the prompt-length buckets, ``transformer.prefill(...,
n_valid=)`` against the unpadded prefill, the unpadded prefill unchanged,
which families pad, and a scheduler's padded admissions (on the CPU the
graphs' work runs eagerly) against ``generate`` at B 1, vlm requests with
and without their frontend rows mixed in one stream.  The CUDA graphs
themselves run only on a card (``chip_smoke.py``'s phase 5b)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.backends import KVCacheLayout, TorchSplitKAttention
from repro_torch.models import registry, transformer
from repro_torch.models.kvcache import init_attn_cache, update_layer_kv
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import (
    Request,
    RequestScheduler,
    prefill_bucket,
    prefill_buckets,
)

ARCHS = {"dense": "internlm2-1.8b", "vlm": "internvl2-2b"}
CAP = 64
# fp32 on the CPU: the kernels' sums take another order as the rows (the
# prompt's length) change, padding or not: the unpadded prefill's own K and
# V at a prompt's first positions move by up to 2.9e-6 (|K| up to ~4, some 8
# ulp) between prompts of 1 and 2 positions, and the padded prefill reads
# 0 to 3.8e-6 from the unpadded one over every length that fits CAP
KV_TOL = dict(rtol=0, atol=1e-5)
LOGITS_TOL = dict(rtol=0, atol=1e-5)


def _model(fam):
    cfg = get_config(ARCHS[fam]).reduced()
    params = transformer.init(torch.Generator().manual_seed(0), cfg,
                              dtype=torch.float32)
    return cfg, params


def _prompt(cfg, S, seed):
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, S)))
    extra = None
    if cfg.frontend_tokens:
        extra = torch.as_tensor(rng.standard_normal(
            (1, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    return tokens, extra


# --------------------------------------------------------------------------
# the buckets


def test_buckets_powers_of_two_then_capacity():
    assert prefill_buckets(1536) == [16, 32, 64, 128, 256, 512, 1024, 1536]
    assert prefill_buckets(1024) == [16, 32, 64, 128, 256, 512, 1024]
    assert prefill_buckets(640) == [16, 32, 64, 128, 256, 512, 640]
    assert prefill_buckets(17) == [16, 17]
    assert prefill_buckets(16) == [16]
    assert prefill_buckets(12) == [12]


@pytest.mark.parametrize("n,want", [(1, 16), (15, 16), (16, 16), (17, 32),
                                    (512, 512), (513, 640), (640, 640)])
def test_bucket_edges(n, want):
    assert prefill_bucket(n, prefill_buckets(640)) == want


def test_bucket_past_capacity_raises():
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        prefill_bucket(641, prefill_buckets(640))


def test_buckets_count_frontend_rows():
    # a bucket of F positions or fewer holds no prompt of F rows + tokens
    assert prefill_buckets(640, frontend=40) == [64, 128, 256, 512, 640]
    assert prefill_buckets(640, frontend=64) == [128, 256, 512, 640]
    assert prefill_buckets(100, frontend=256) == [100]
    buckets = prefill_buckets(640, frontend=40)
    assert prefill_bucket(1 + 40, buckets) == 64
    assert prefill_bucket(24 + 40, buckets) == 64
    assert prefill_bucket(25 + 40, buckets) == 128


# --------------------------------------------------------------------------
# transformer.prefill with n_valid


@pytest.mark.parametrize("fam", sorted(ARCHS))
@pytest.mark.parametrize("S", [1, 4, 9, 38])
def test_padded_prefill_matches_unpadded(fam, S):
    cfg, params = _model(fam)
    F = cfg.frontend_tokens or 0
    bucket = prefill_bucket(S + F, prefill_buckets(CAP, F))
    tokens, extra = _prompt(cfg, S, seed=S)
    want_logits, want = transformer.prefill(params, tokens, cfg, CAP,
                                            extra_embeds=extra)
    padded = torch.cat([tokens, torch.zeros((1, bucket - F - S),
                                            dtype=tokens.dtype)], dim=1)
    n = torch.tensor(S + F, dtype=torch.int32)
    logits, cache = transformer.prefill(params, padded, cfg, CAP,
                                        extra_embeds=extra, n_valid=n)
    assert int(cache["length"]) == S + F
    assert cache["length"].dtype == torch.int32
    assert logits.shape == want_logits.shape
    torch.testing.assert_close(logits, want_logits, **LOGITS_TOL)
    assert torch.equal(logits.argmax(-1), want_logits.argmax(-1))
    for key in ("k", "v"):
        assert cache[key].shape == want[key].shape
        torch.testing.assert_close(cache[key][..., :S + F, :],
                                   want[key][..., :S + F, :], **KV_TOL)
        assert not cache[key][..., bucket:, :].any()


def _parent_prefill(params, tokens, cfg, max_len, extra_embeds=None,
                    layout=KVCacheLayout()):
    """``transformer.prefill`` as it was before it took ``n_valid``: the
    same ops, kept here as the saved call that the function without
    ``n_valid`` must still equal bit for bit."""
    x = transformer.embed_with_extra(params.embed, tokens, extra_embeds)
    B, S, _ = x.shape
    positions = torch.arange(S)[None, :].expand(B, S)
    cache = init_attn_cache(len(params.blocks), B, max_len, cfg.eff_kv_heads,
                            cfg.d_head, dtype=x.dtype, layout=layout)
    for i, block in enumerate(params.blocks):
        x, k, v = transformer._attn_prefill(block, x, cfg, positions)
        update_layer_kv(cache, i, k, v, 0)
        x = transformer._mlp_apply(block, x, cfg)
    cache["length"].fill_(S)
    return transformer.final_logits(x[:, -1:], params.ln_f, params.head,
                                    cfg), cache


@pytest.mark.parametrize("fam", sorted(ARCHS))
def test_unpadded_prefill_unchanged(fam):
    cfg, params = _model(fam)
    tokens, extra = _prompt(cfg, 13, seed=3)
    layout = KVCacheLayout(block_k=8)
    logits, cache = transformer.prefill(params, tokens, cfg, 40,
                                        extra_embeds=extra, layout=layout)
    want_logits, want = _parent_prefill(params, tokens, cfg, 40,
                                        extra_embeds=extra, layout=layout)
    assert torch.equal(logits, want_logits)
    assert sorted(cache) == sorted(want)
    for key in want:
        assert cache[key].dtype == want[key].dtype
        assert torch.equal(cache[key], want[key])


# --------------------------------------------------------------------------
# which families pad


@pytest.mark.parametrize("arch,pads", [
    ("internlm2-1.8b", True), ("internvl2-2b", True),
    ("deepseek-moe-16b", False), ("zamba2-7b", False),
    ("mamba2-370m", False), ("seamless-m4t-medium", False)])
def test_prefill_pads_by_family(arch, pads):
    model = registry.get_model(get_config(arch).reduced(),
                               attn_backend="dense-ref")
    assert model.prefill_pads is pads


def _engine(fam):
    cfg, params = _model(fam) if fam in ARCHS else (
        get_config(fam).reduced(), None)
    return ServingEngine(cfg, params=params, device="cpu",
                         attn_backend=TorchSplitKAttention(block_k=4,
                                                           device="cpu"))


def _scheduler(eng):
    need = 40 + 4 + (eng.cfg.frontend_tokens or 0)
    layout = eng.cache_layout(need)
    return RequestScheduler(eng.model, eng.params, 2, layout.padded_len(need),
                            layout=layout, device="cpu")


def _recording(sched, monkeypatch):
    """Record each prefill's batch (its tokens' width and whether it holds
    frontend rows) and ``n_valid`` through ``sched``'s model."""
    seen = []
    prefill = sched.model.prefill

    def recording(p, batch, max_len, **kw):
        n = kw.get("n_valid")
        seen.append((batch["tokens"].shape[1], sorted(set(batch) - {"tokens"}),
                     None if n is None else int(n)))
        return prefill(p, batch, max_len, **kw)

    monkeypatch.setattr(sched.model, "prefill", recording)
    return seen


def test_scheduler_keeps_the_unpadded_prefill_for_a_family_that_does_not_pad(
        monkeypatch):
    eng = _engine("deepseek-moe-16b")
    sched = _scheduler(eng)
    seen = _recording(sched, monkeypatch)
    reqs = _requests(eng.cfg, 3, seed=5)
    sched.run(reqs)
    assert not hasattr(sched, "_pf_tokens")
    assert sorted(seen) == sorted((len(r.prompt), [], None) for r in reqs)
    assert sched.prefill_captures == sched.prefill_replays == 0


# --------------------------------------------------------------------------
# a scheduler that pads its admissions


def _requests(cfg, n, seed, text_only=()):
    """``n`` requests; those with rid in ``text_only`` come without the
    family's frontend rows."""
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(
                        rng.integers(1, 41))).astype(np.int32),
                    max_new_tokens=int(rng.integers(1, 5)),
                    arrival=int(rng.integers(0, 3)))
            for i in range(n)]
    if cfg.frontend_tokens:
        for r in reqs:
            rows = rng.standard_normal(
                (1, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
            if r.rid not in text_only:
                r.extra = {"extra_embeds": rows}
    return reqs


def _against_generate(eng, sched, reqs, got):
    """Each result against ``generate`` at B 1 and the slot capacity (the
    unpadded prefill, products at M 1): tokens identical, logits within
    1e-4 (the scheduler's contract); then each bit for bit itself served
    alone through ``sched``."""
    assert sorted(got) == sorted(r.rid for r in reqs)
    for r in reqs:
        g = eng.generate(np.asarray(r.prompt)[None], r.max_new_tokens,
                         extra=r.extra, max_len=sched.slot_capacity)
        assert np.array_equal(got[r.rid].tokens, g.tokens[0])
        np.testing.assert_allclose(got[r.rid].final_logits,
                                   g.prefill_logits[0], rtol=0, atol=1e-4)
    for r in reqs:
        solo = sched.run([dataclasses.replace(r, arrival=0)])[0]
        assert np.array_equal(solo.tokens, got[r.rid].tokens)
        assert np.array_equal(solo.final_logits, got[r.rid].final_logits)
    assert sched.pool.allocator.live_blocks == 0


@pytest.mark.parametrize("fam", sorted(ARCHS))
def test_padded_admissions_serve_the_stream(fam, monkeypatch):
    eng = _engine(fam)
    F = eng.cfg.frontend_tokens or 0
    reqs = _requests(eng.cfg, 6, seed=7)
    sched = _scheduler(eng)
    seen = _recording(sched, monkeypatch)
    got = {r.rid: r for r in sched.run(reqs)}
    buckets = prefill_buckets(sched.slot_capacity, F)
    assert len(buckets) >= 3
    order = sorted(reqs, key=lambda r: (r.arrival, r.rid))
    assert [b for b, _, _ in seen] == [
        prefill_bucket(len(r.prompt) + F, buckets) - F for r in order]
    assert [n for _, _, n in seen] == [len(r.prompt) + F for r in order]
    assert sched.prefill_captures == sched.prefill_replays == 0
    _against_generate(eng, sched, reqs, got)


@pytest.mark.parametrize("fam", sorted(ARCHS))
def test_padded_admissions_take_the_graph_shapes(fam, monkeypatch):
    # every admission of a padded family reads the static inputs the
    # graphs hold: the token buffer's prefix, the frontend rows and n
    eng = _engine(fam)
    sched = _scheduler(eng)
    seen = []
    prefill = sched.model.prefill

    def recording(p, batch, max_len, **kw):
        seen.append((batch["tokens"].data_ptr(), kw["n_valid"] is sched._pf_n,
                     {k: v is sched._pf_extra[k] for k, v in batch.items()
                      if k != "tokens"}))
        return prefill(p, batch, max_len, **kw)

    monkeypatch.setattr(sched.model, "prefill", recording)
    sched.run(_requests(eng.cfg, 3, seed=2))
    keys = {"extra_embeds": True} if eng.cfg.frontend_tokens else {}
    assert seen == [(sched._pf_tokens.data_ptr(), True, keys)] * 3


def test_vlm_request_without_frontend_rows_is_refused(monkeypatch):
    # the family's prefill takes its image rows (the reference's scheduler
    # and the unpadded prefill raise KeyError without them); the padded
    # prefill would read the frontend buffer another request left, so the
    # stream is refused before any admission
    eng = _engine("vlm")
    reqs = _requests(eng.cfg, 4, seed=11, text_only={2})
    with pytest.raises(KeyError):
        eng.generate(np.asarray(reqs[2].prompt)[None], 1)
    sched = _scheduler(eng)
    seen = _recording(sched, monkeypatch)
    with pytest.raises(ValueError, match="request 2 has no 'extra_embeds'"):
        sched.run(reqs)
    assert seen == [] and sched.steps_run == 0
    assert sched.pool.allocator.live_blocks == 0
    served = [r for r in reqs if r.extra]
    got = {r.rid: r for r in sched.run(served)}
    _against_generate(eng, sched, served, got)
