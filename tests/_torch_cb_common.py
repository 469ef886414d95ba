"""Shared setup of the port's continuous-batching tests
(``tests/test_torch_continuous_batching.py`` and the per-family
``tests/test_torch_cb_*.py``): the families at their ``reduced()`` sizes
on the reference's fp32-cast params, the request streams, and the three
contracts of :class:`DifferentialParity`, whose test methods each
``test_torch_cb_*`` file runs over its own ``diff_case`` fixture.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.core.backends import ChunkedLseAttention as RefChunked
from repro.core.backends import PallasSplitKAttention
from repro.models import encdec as ref_encdec
from repro.models import hybrid as ref_hybrid
from repro.models import mamba2 as ref_mamba2
from repro.models import moe as ref_moe
from repro.models import transformer as ref_transformer
from repro.serving.engine import ServingEngine as RefEngine
from repro.serving.scheduler import Request as RefRequest
from repro_torch.configs import get_config
from repro_torch.core.backends import (
    ChunkedLseAttention,
    DenseRefAttention,
    TorchSplitKAttention,
)
from repro_torch.models import encdec, hybrid, mamba2, moe, transformer
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import Request
from _xla_strict import strict_jit

BLOCK_K = 4          # a small kernel block, so pool pages are a few tokens
NUM_SLOTS = 2
TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)

FAMILIES = {"dense": ("internlm2-1.8b", ref_transformer, transformer),
            "moe": ("deepseek-moe-16b", ref_moe, moe),
            "ssm": ("mamba2-370m", ref_mamba2, mamba2),
            "hybrid": ("zamba2-7b", ref_hybrid, hybrid),
            "encdec": ("seamless-m4t-medium", ref_encdec, encdec),
            "vlm": ("internvl2-2b", ref_transformer, transformer)}
# the ssm family has no decode attention: one (unused) backend
BACKENDS = {"dense": ("dense-ref", "chunked-lse", "torch-splitk"),
            "moe": ("dense-ref", "torch-splitk"),
            "ssm": ("dense-ref",),
            "hybrid": ("dense-ref", "torch-splitk"),
            "encdec": ("dense-ref", "torch-splitk"),
            "vlm": ("dense-ref", "torch-splitk")}
# the frontend input each admission carries (random from the stream's seed)
EXTRA_KEY = {"vlm": "extra_embeds", "encdec": "frames"}
PORT_BACKEND = {
    "dense-ref": lambda: DenseRefAttention(),
    "chunked-lse": lambda: ChunkedLseAttention(kv_chunk=3),
    "torch-splitk": lambda: TorchSplitKAttention(block_k=BLOCK_K, device="cpu"),
}
REF_BACKEND = {
    "dense-ref": lambda: "dense-ref",
    "chunked-lse": lambda: RefChunked(kv_chunk=3),
    "torch-splitk": lambda: PallasSplitKAttention(block_k=BLOCK_K),
}
ARRIVAL_ORDERS = {
    "together": lambda n: [0] * n,
    "staggered": lambda n: list(range(n)),
    "reversed": lambda n: list(range(n - 1, -1, -1)),
}


@functools.lru_cache(maxsize=None)
def _family(fam):
    """(family, port cfg, reference cfg, reference fp32 params, the port's
    fp32 params): the reference's init, cast to fp32 and carried over."""
    arch, ref_mod, mod = FAMILIES[fam]
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          ref_mod.init(jax.random.key(0), ref_cfg))
    port = mod.params_from_arrays(
        cfg, jax.tree.map(lambda a: None if a is None else np.asarray(a), params),
        device="cpu", dtype=torch.float32)
    return fam, cfg, ref_cfg, params, port


def _mk_requests(cfg, rng, n, arrivals):
    """Ragged prompts (2..7) and budgets (1..4), as the reference's suite,
    with the family's frontend embeddings ``[1, F, d]``."""
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        (int(rng.integers(2, 8)),)).astype(np.int32),
                    max_new_tokens=int(rng.integers(1, 5)),
                    arrival=int(arrivals[i]))
            for i in range(n)]
    if cfg.family in EXTRA_KEY:
        for r in reqs:
            r.extra = {EXTRA_KEY[cfg.family]: rng.standard_normal(
                (1, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)}
    return reqs


def _ref_requests(reqs):
    return [RefRequest(rid=r.rid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens, extra=r.extra,
                       arrival=r.arrival)
            for r in reqs]


def _stream_capacity(eng, reqs):
    need = max(np.asarray(r.prompt).reshape(-1).shape[0] + r.max_new_tokens
               for r in reqs) + (eng.cfg.frontend_tokens or 0)
    return eng.cache_layout(need).padded_len(need)


ENGINE_CASES = [(fam, be) for fam in sorted(FAMILIES) for be in BACKENDS[fam]]


def case_ids(cases):
    return [f"{f}-{b}" for f, b in cases]


def make_diff_case(fam, backend):
    """(port engine, reference engine, requests, capacity, solo, static):
    each request's tokens and final logits served alone through a port
    scheduler of the stream's width and capacity (``solo``), and through
    the port's ``generate`` at B = 1 and ``max_len = capacity``
    (``static``).  A ``test_torch_cb_*`` file's module fixture
    ``diff_case`` returns it."""
    _, cfg, ref_cfg, params, port = _family(fam)
    eng = ServingEngine(cfg, params=port, device="cpu",
                        attn_backend=PORT_BACKEND[backend]())
    ref_eng = RefEngine(ref_cfg, params=params,
                        attn_backend=REF_BACKEND[backend]())
    if fam == "encdec":
        ref_eng._prefill = strict_jit(ref_eng.model.prefill, static_argnums=(2,))
    reqs = _mk_requests(cfg, np.random.default_rng(7), 4, np.zeros(4, int))
    cap = _stream_capacity(eng, reqs)
    assert cap == ref_eng.cache_layout(cap).padded_len(cap)
    solo, static = {}, {}
    for r in reqs:
        res = eng.generate_stream([r], num_slots=NUM_SLOTS, max_request_len=cap)
        solo[r.rid] = (res[0].tokens, res[0].final_logits)
        g = eng.generate(np.asarray(r.prompt)[None], r.max_new_tokens,
                         extra=r.extra, max_len=cap)
        static[r.rid] = (g.tokens[0], g.prefill_logits[0])
    return eng, ref_eng, reqs, cap, solo, static


def _hold(results, ref_results, solo, static, n_base, label):
    """The three contracts, request by request."""
    ref = {r.rid: r for r in ref_results}
    assert sorted(ref) == sorted(r.rid for r in results)
    for res in results:
        base = res.rid % n_base
        msg = f"{label} rid={res.rid}"
        assert res.final_logits.dtype == np.float32
        np.testing.assert_array_equal(res.tokens, solo[base][0], err_msg=msg)
        assert np.array_equal(res.final_logits, solo[base][1]), \
            f"{msg}: logits not bit for bit the solo run's"
        np.testing.assert_array_equal(res.tokens, static[base][0], err_msg=msg)
        np.testing.assert_allclose(res.final_logits, static[base][1],
                                   err_msg=msg, **TOL)
        np.testing.assert_array_equal(res.tokens, ref[res.rid].tokens,
                                      err_msg=msg)
        np.testing.assert_allclose(res.final_logits, ref[res.rid].final_logits,
                                   err_msg=msg, **TOL)


class DifferentialParity:
    """Stream ≡ solo bit for bit; ≈ ``generate`` and the reference.  A
    ``test_torch_cb_*`` file subclasses it as ``TestDifferentialParity``
    beside its ``diff_case`` fixture."""

    @pytest.mark.parametrize("order", sorted(ARRIVAL_ORDERS))
    def test_stream_matches_solo_static_and_reference(self, diff_case, order):
        eng, ref_eng, base, cap, solo, static = diff_case
        arrivals = ARRIVAL_ORDERS[order](len(base))
        reqs = [dataclasses.replace(r, arrival=a) for r, a in zip(base, arrivals)]
        results = eng.generate_stream(reqs, num_slots=NUM_SLOTS,
                                      max_request_len=cap)
        want = ref_eng.generate_stream(_ref_requests(reqs), num_slots=NUM_SLOTS,
                                       max_request_len=cap)
        _hold(results, want, solo, static, len(base), order)

    def test_mid_stream_admission_reuses_freed_pages(self, diff_case):
        """Two waves of the same requests under new rids: wave 2 decodes on
        pages wave 1 dirtied, and no stale value reaches its logits."""
        eng, ref_eng, base, cap, solo, static = diff_case
        wave2 = [dataclasses.replace(r, rid=r.rid + len(base), arrival=3)
                 for r in base]
        results = eng.generate_stream(list(base) + wave2, num_slots=NUM_SLOTS,
                                      max_request_len=cap)
        want = ref_eng.generate_stream(_ref_requests(list(base) + wave2),
                                       num_slots=NUM_SLOTS, max_request_len=cap)
        assert len(results) == 2 * len(base)
        _hold(results, want, solo, static, len(base), "two waves")
