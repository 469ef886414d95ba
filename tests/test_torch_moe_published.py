"""deepseek-moe-16b's routing as published, on the CPU at a tiny size (no
JAX): ``moe_norm_topk_prob`` False (a softmax over all E experts, the top
k used as they are) and ``moe_capacity_factor`` None (no capacity, no token
dropped), against the benchmark's plain reference
(``portbench/reference/moe.py``) on the seed's fp32 weights: the forward
pass, and a prefill then decode steps through the cache, at 1e-4; the
padded prefill (``prefill(..., n_valid=)``) against the unpadded one, the
moe layer bit for bit and the whole prefill within the chunked attention's
reordering (1e-5, as ``test_torch_prefill_buckets.py`` holds the dense
one); a prompt whose tokens all pick the same experts keeps every
assignment, where the reference's capacity factor 1.25 still drops past
``C``; the scheduler serves the published configuration from padded
prefills; the routing counters (``core/spans.py``) count what they say,
dropped 0 without a capacity."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import spans
from repro_torch.core.backends import KVCacheLayout, TorchSplitKAttention
from repro_torch.models import moe, registry
from repro_torch.serving.scheduler import Request, RequestScheduler

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "portbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from pbcore import weights  # noqa: E402
from reference import moe as plain  # noqa: E402

SEED = 2**35 + 11
BLOCK_K = 4
CAP = 48
TOL = dict(rtol=1e-4, atol=1e-4)
PAD_TOL = dict(rtol=0, atol=1e-5)

# configs/deepseek_moe_16b.py's ``reduced()`` shape, routed as published,
# in fp32 (the benchmark's configuration file's keys)
TINY = {
    "name": "tiny-moe", "family": "moe", "n_layers": 4, "d_model": 128,
    "n_heads": 4, "n_kv_heads": 4, "d_head": 32, "d_ff": 256,
    "vocab_size": 512, "padded_vocab": 512, "n_experts": 8,
    "n_shared_experts": 1, "experts_per_token": 2, "moe_d_ff": 64,
    "first_dense_layers": 1, "moe_capacity_factor": None,
    "moe_norm_topk_prob": False, "moe_cache_dtype": "float32",
    "rope_theta": 10000.0, "norm_eps": 1e-06, "tie_embeddings": False,
    "param_dtype": "float32", "kv_cache_dtype": "float32",
}


@pytest.fixture(scope="module")
def tiny():
    """(the port's config, its module filled with the seed's weights, the
    reference's view of the same weights)."""
    from entries.stream import _module, port_config

    cfg = port_config(TINY)
    module = _module(cfg, TINY, "cpu")
    weights.fill(module, TINY, SEED)
    return cfg, module, weights.Weights(TINY, SEED, "cpu")


def _api(cfg):
    return registry.get_model(cfg, TorchSplitKAttention(block_k=BLOCK_K,
                                                        device="cpu"))


def _seqs(n_tokens, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, TINY["vocab_size"], (n,), generator=g)
            for n in n_tokens]


def _reference(w, seq):
    return plain.logits(w, TINY, [seq], torch.arange(len(seq)), [len(seq)])


def test_the_published_preset_keys():
    """The registered preset routes as the reference; the benchmark's file
    names the published keys."""
    cfg = get_config("deepseek-moe-16b")
    assert cfg.moe_norm_topk_prob is True and cfg.moe_capacity_factor == 1.25
    assert moe.cache_dtype(cfg) == moe.DECODE_CACHE_DTYPE == torch.float32
    assert not _api(cfg.reduced()).prefill_pads
    pub = dataclasses.replace(cfg.reduced(), moe_capacity_factor=None)
    assert _api(pub).prefill_pads
    bf16 = dataclasses.replace(cfg, moe_cache_dtype="bfloat16")
    assert moe.cache_dtype(bf16) == torch.bfloat16
    with pytest.raises(ValueError):
        moe.cache_dtype(dataclasses.replace(cfg, moe_cache_dtype="int8"))


def test_route_topk_weights_are_the_top_k_of_a_softmax_over_all():
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(37, 8, generator=g)
    logits[3, 2] = logits[3, 5] = 4.0           # a tie: the lower id first
    w_norm, ids_norm = moe.route_topk(logits, 3)
    w, ids = moe.route_topk(logits, 3, normalize=False)
    assert torch.equal(ids, ids_norm)
    assert ids[3].tolist().index(2) < ids[3].tolist().index(5)
    probs = torch.softmax(logits, dim=-1)
    assert torch.equal(w, torch.gather(probs, 1, ids))
    assert (w.sum(-1) < 1).all()
    torch.testing.assert_close(w / w.sum(-1, keepdim=True), w_norm,
                               rtol=1e-6, atol=1e-7)


def test_forward_matches_the_plain_reference(tiny):
    cfg, module, w = tiny
    for seq in _seqs((9, 23)):
        got = moe.forward(module, seq[None], cfg)[0][0]
        torch.testing.assert_close(got, _reference(w, seq), **TOL)


def test_prefill_then_decode_matches_the_reference(tiny):
    """A prompt's prefill, then each served token decoded through the
    cache: every position's logits against the reference's forward pass
    over the whole sequence."""
    cfg, module, w = tiny
    api = _api(cfg)
    prompt, steps = _seqs((13,), seed=3)[0], 9
    logits, cache = api.prefill(module, {"tokens": prompt[None]}, CAP)
    got, tokens = [logits[0, -1]], []
    for _ in range(steps):
        tokens.append(int(got[-1].argmax()))
        logits, cache = api.decode_step(
            module, torch.tensor([[tokens[-1]]]), cache)
        got.append(logits[0, -1])
    seq = torch.cat([prompt, torch.tensor(tokens)])
    want = _reference(w, seq)[len(prompt) - 1:]
    torch.testing.assert_close(torch.stack(got), want, **TOL)
    assert cache["stacks"][-1]["k"].dtype == torch.float32


@pytest.mark.parametrize("n,bucket", [(1, 16), (11, 16), (16, 16), (17, 32)])
def test_padded_prefill_against_unpadded(tiny, n, bucket):
    cfg, module, _ = tiny
    api = _api(cfg)
    prompt = _seqs((n,), seed=n)[0]
    padded = torch.cat([prompt, torch.zeros(bucket - n, dtype=torch.long)])
    want, want_cache = api.prefill(module, {"tokens": prompt[None]}, CAP)
    got, cache = api.prefill(module, {"tokens": padded[None]}, CAP,
                             n_valid=torch.tensor(n, dtype=torch.int32))
    torch.testing.assert_close(got, want, **PAD_TOL)
    assert int(cache["length"]) == n
    for a, b in zip(cache["stacks"], want_cache["stacks"]):
        for key in ("k", "v"):
            torch.testing.assert_close(a[key][..., :n, :], b[key][..., :n, :],
                                       **PAD_TOL)
    # the moe layer itself pads bit for bit: a padded token's routing
    # takes nothing from a real one's (a one-token prompt's one-row
    # products take the CPU's vector path, another sum order)
    x = torch.randn(1, bucket, cfg.d_model,
                    generator=torch.Generator().manual_seed(n))
    ffn = module.moe_blocks[0].moe
    alone, _ = moe.moe_ffn(ffn, x[:, :n], cfg, metrics=False)
    mixed, _ = moe.moe_ffn(ffn, x, cfg, metrics=False)
    if n > 1:
        assert torch.equal(mixed[:, :n], alone)
    torch.testing.assert_close(mixed[:, :n], alone, rtol=0, atol=1e-6)


def test_a_padded_prefill_at_a_capacity_is_refused(tiny):
    cfg, module, _ = tiny
    ref_cfg = dataclasses.replace(cfg, moe_capacity_factor=1.25)
    with pytest.raises(ValueError, match="no capacity"):
        moe.prefill(module, torch.zeros((1, 16), dtype=torch.long), ref_cfg,
                    CAP, n_valid=torch.tensor(3, dtype=torch.int32))


def _same_expert_prompt(cfg, module, S):
    """``[1, S, d]``: one hidden state S times, so every token picks the
    same k experts."""
    x = torch.randn(1, 1, cfg.d_model, generator=torch.Generator().manual_seed(5))
    return x.expand(1, S, cfg.d_model).contiguous()


def test_every_token_on_one_expert_is_kept_without_capacity(tiny):
    cfg, module, _ = tiny
    S, k, E = 24, cfg.experts_per_token, cfg.n_experts
    ffn = module.moe_blocks[0].moe
    x = _same_expert_prompt(cfg, module, S)
    out, _, ids, valid = moe._routed_experts(
        ffn.router, ffn.w_gate, ffn.w_up, ffn.w_down, x, cfg)
    assert len(set(ids.reshape(-1).tolist())) == k       # k experts, S each
    assert valid.shape == (1, E, S) and int(valid.sum()) == S * k
    assert torch.equal(out, out[:1].expand(S, cfg.d_model))  # each kept
    one, _, _, _ = moe._routed_experts(
        ffn.router, ffn.w_gate, ffn.w_up, ffn.w_down, x[:, :1], cfg)
    torch.testing.assert_close(out[:1], one, rtol=0, atol=1e-6)


def test_the_reference_factor_still_drops_past_capacity(tiny):
    cfg, module, _ = tiny
    ref_cfg = dataclasses.replace(cfg, moe_capacity_factor=1.25,
                                  moe_norm_topk_prob=True)
    S, k, E = 24, cfg.experts_per_token, cfg.n_experts
    C = int(-(-S * k // E) * 1.25)
    assert moe.capacity(ref_cfg, S) == C == 7 and moe.capacity(cfg, S) == S
    ffn = module.moe_blocks[0].moe
    x = _same_expert_prompt(cfg, module, S)
    out, _, ids, valid = moe._routed_experts(
        ffn.router, ffn.w_gate, ffn.w_up, ffn.w_down, x, ref_cfg)
    assert int(valid.sum()) == k * C                  # S - C tokens dropped
    kept = out.abs().sum(-1) > 0
    assert kept[:C].all() and not kept[C:].any()      # the first C stay


def test_counters_count_the_routing(tiny):
    cfg, module, _ = tiny
    S, k, E = 24, cfg.experts_per_token, cfg.n_experts
    n_moe = cfg.n_layers - cfg.first_dense_layers
    api = _api(cfg)
    prompt = torch.full((1, S), 7, dtype=torch.long)  # one token S times
    spans.reset_counters()
    api.prefill(module, {"tokens": prompt}, CAP)
    with spans.tally("moe.prefill"):   # an inner tally counts into this one
        api.prefill(module, {"tokens": prompt}, CAP)
    ref_cfg = dataclasses.replace(cfg, moe_capacity_factor=1.25)
    _api(ref_cfg).prefill(module, {"tokens": prompt}, CAP)
    c = spans.counters()["moe.prefill"]
    # a repeated token routes alike at every position, though its hidden
    # states differ by position (RoPE), so count experts per layer
    assert c["steps"] == 3 and c["layer_calls"] == 3 * n_moe
    assert c["assignments"] == 3 * n_moe * S * k
    C = moe.capacity(ref_cfg, S)
    per_layer_hits = c["experts_hit"] / c["layer_calls"]
    assert 1 <= per_layer_hits <= E
    assert 1.0 <= c["load_max_over_mean"] / c["layer_calls"] <= E / k
    # without a capacity nothing drops; the reference's run drops
    # whatever passed C, and no more than every assignment past C a layer
    assert 0 < c["dropped"] <= n_moe * (S * k - C)
    spans.reset_counters()
    api.prefill(module, {"tokens": prompt}, CAP)
    assert spans.counters()["moe.prefill"]["dropped"] == 0


def test_counters_of_one_known_routing():
    """Expert ids given directly: hits, the most-loaded over the mean and
    the drops, summed over two layers."""
    spans.reset_counters()
    ids = torch.tensor([[0, 1], [0, 2], [0, 1]])          # 6 assignments
    kept = torch.tensor([True, True, True, True, False, False])
    with spans.tally("test.phase"):
        spans.count_routing(ids, kept, 4)
        spans.count_routing(torch.tensor([[3, 2], [1, 0], [2, 3]]),
                            torch.ones(6, dtype=torch.bool), 4)
    c = spans.counters()["test.phase"]
    assert c == {"steps": 1.0, "layer_calls": 2.0, "assignments": 12.0,
                 "dropped": 2.0, "experts_hit": 3.0 + 4.0,
                 "load_max_over_mean": 3 / 1.5 + 2 / 1.5}


def test_the_scheduler_serves_padded_prefills(tiny):
    """The published configuration through ``RequestScheduler`` on the
    CPU: every admission padded to its bucket, each request's tokens the
    reference's greedy choice at every position, decode drops nothing."""
    cfg, module, w = tiny
    api = _api(cfg)
    assert api.prefill_pads
    layout = KVCacheLayout(BLOCK_K)
    sched = RequestScheduler(api, module, num_slots=3, slot_capacity=CAP,
                             layout=layout, device="cpu")
    prompts = _seqs((5, 17, 2, 30), seed=9)
    reqs = [Request(rid=i, prompt=p.numpy().astype(np.int32),
                    max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, (6, 4, 9, 5)))]
    spans.reset_counters()
    results = {r.rid: r for r in sched.run(reqs)}
    c = spans.counters()
    assert c["moe.decode"]["steps"] == sched.steps_run
    assert c["moe.decode"]["dropped"] == 0 == c["moe.prefill"]["dropped"]
    assert c["moe.prefill"]["steps"] == len(reqs)
    for r in reqs:
        seq = torch.cat([torch.as_tensor(r.prompt, dtype=torch.long),
                         torch.as_tensor(results[r.rid].tokens[:-1],
                                         dtype=torch.long)])
        want = _reference(w, seq)[len(r.prompt) - 1:].argmax(-1)
        assert want.tolist() == results[r.rid].tokens.tolist()


def test_the_moe_layer_records_its_four_spans(tiny):
    """On the eager path each moe layer opens ``moe.route``,
    ``moe.dispatch``, ``moe.experts`` and ``moe.combine`` once, in that
    order, under a profiler; the profiler moves no bit."""
    from torch.profiler import ProfilerActivity, profile

    cfg, module, _ = tiny
    api = _api(cfg)
    prompt = _seqs((9,), seed=4)[0][None]
    want, _ = api.prefill(module, {"tokens": prompt}, CAP)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got, _ = api.prefill(module, {"tokens": prompt}, CAP)
    assert torch.equal(got, want)
    names = [e.name() for e in sorted(prof.profiler.kineto_results.events(),
                                      key=lambda e: e.start_ns())
             if e.name() in spans.MOE_SPANS]
    n_moe = cfg.n_layers - cfg.first_dense_layers
    assert names == list(spans.MOE_SPANS) * n_moe
