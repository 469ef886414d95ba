"""The port's Mamba-2 family (``repro_torch.models.mamba2``, served by
``repro_torch.serving.engine``) against the JAX package, on
``mamba2-370m.reduced()`` (4 layers, d_model 128, 8 SSM heads of 32, state
16, chunk 32).

Both sides hold the same weights: the reference's ``mamba2.init`` params,
carried over with ``mamba2.params_from_arrays``.  In fp32 (params cast)
logits are held to 1e-4, the reference's own fp32 model-level tolerance
(``tests/test_attention_backends.py``), since the two sides sum in
different orders, and greedy tokens must be identical.  The prompts are 40
tokens long, so prefill pads the second chunk of 32.  The bf16 path runs on
this CPU in the reference too (the Mamba-2 einsums ask for fp32 results),
so the port's bf16 path is held to it: logits within 3e-2, the reference's
bf16 logits tolerance, and at least 90% of the greedy tokens equal (both
sides round to bf16 at the same points, but a rounding tie can flip a
close greedy pick, after which the two generations part ways).
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import mamba2 as ref_mamba2  # noqa: E402
from repro.serving import router as ref_router  # noqa: E402
from repro.serving.engine import ServingEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serving import router  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from _port_keys import as_port  # noqa: E402

ARCH = "mamba2-370m"
B, S_PROMPT, NEW = 2, 40, 4
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
BF16_AGREE_MIN = 0.9


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def case():
    """(cfg, ref cfg, reference bf16 params, fp32-cast params, the port's
    fp32 params, prompts)."""
    cfg = get_config(ARCH).reduced()
    ref_cfg = ref_get_config(ARCH).reduced()
    params16 = ref_mamba2.init(jax.random.key(0), ref_cfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params16)
    port = mamba2.params_from_arrays(cfg, jax.tree.map(np.asarray, params),
                                     device="cpu", dtype=torch.float32)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(B, S_PROMPT)).astype(np.int32)
    return cfg, ref_cfg, params16, params, port, prompts


@pytest.fixture(scope="module")
def prefilled(case):
    cfg, ref_cfg, _, params, port, prompts = case
    want = ref_mamba2.prefill(params, jnp.asarray(prompts), ref_cfg)
    got = mamba2.prefill(port, torch.from_numpy(prompts).long(), cfg)
    return want, got


def test_config_and_params_carry_over(case):
    cfg, ref_cfg, _, params, port, _ = case
    assert ARCH in list_archs()
    assert dataclasses.asdict(get_config(ARCH)) == as_port(ref_get_config(ARCH))
    assert dataclasses.asdict(cfg) == as_port(ref_cfg)
    assert get_config(ARCH).param_count() == ref_get_config(ARCH).param_count()
    assert sum(p.numel() for p in port.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))
    np.testing.assert_array_equal(_np(port.embed), np.asarray(params["embed"]))
    np.testing.assert_array_equal(
        _np(port.blocks[-1].conv_x_w),
        np.asarray(params["blocks"]["conv_x_w"][-1]))


def test_fp32_leaves_stay_fp32_after_carry_over(case):
    cfg, _, params16, _, _, _ = case
    port16 = mamba2.params_from_arrays(cfg, jax.tree.map(np.asarray, params16),
                                       device="cpu", dtype=torch.bfloat16)
    for blk in port16.blocks:
        for name, p in blk.named_parameters():
            want = torch.float32 if name in ("A_log", "dt_bias", "D") else torch.bfloat16
            assert p.dtype == want, name
    assert port16.embed.dtype == torch.bfloat16
    # bf16 → fp32 → bf16 is exact
    np.testing.assert_array_equal(_np(port16.embed),
                                  np.asarray(params16["embed"], np.float32))
    np.testing.assert_array_equal(
        _np(port16.blocks[1].dt_bias), np.asarray(params16["blocks"]["dt_bias"][1]))
    drawn = mamba2.init(torch.Generator().manual_seed(0), cfg)
    assert drawn.blocks[0].A_log.dtype == torch.float32
    assert drawn.blocks[0].in_x.dtype == torch.bfloat16
    assert float(drawn.blocks[0].dt_bias[0]) == -2.0


def test_prefill_logits_and_cache_match(case, prefilled):
    cfg = case[0]
    (want_logits, want_cache), (logits, cache) = prefilled
    assert logits.shape == (B, 1, cfg.padded_vocab())
    np.testing.assert_allclose(_np(logits), _np(want_logits), **TOL)
    for key in ("x", "B", "C"):
        assert tuple(cache["conv"][key].shape) == want_cache["conv"][key].shape
        np.testing.assert_allclose(_np(cache["conv"][key]),
                                   _np(want_cache["conv"][key]), **TOL)
    assert cache["ssm"].dtype == torch.float32
    np.testing.assert_allclose(_np(cache["ssm"]), _np(want_cache["ssm"]), **TOL)
    assert int(cache["length"]) == int(want_cache["length"]) == S_PROMPT


def test_forward_logits_match(case):
    cfg, ref_cfg, _, params, port, prompts = case
    want = ref_mamba2.forward(params, jnp.asarray(prompts), ref_cfg)
    got = mamba2.forward(port, torch.from_numpy(prompts).long(), cfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_decode_step_logits_match(case, prefilled):
    """Teacher-forced on the reference's greedy tokens, every step's logits
    and state within 1e-4."""
    cfg, ref_cfg, _, params, port, _ = case
    (want_logits, want_cache), (_, cache) = prefilled
    cache = {**cache, "conv": {k: v.clone() for k, v in cache["conv"].items()},
             "ssm": cache["ssm"].clone()}
    token = jnp.argmax(want_logits, axis=-1).astype(jnp.int32)
    for _ in range(NEW):
        want_logits, want_cache = ref_mamba2.decode_step(params, token,
                                                         want_cache, ref_cfg)
        logits, cache = mamba2.decode_step(
            port, torch.from_numpy(np.array(token)).long(), cache, cfg)
        np.testing.assert_allclose(_np(logits), _np(want_logits), **TOL)
        np.testing.assert_allclose(_np(cache["ssm"]), _np(want_cache["ssm"]),
                                   **TOL)
        token = jnp.argmax(want_logits, axis=-1).astype(jnp.int32)
    assert int(cache["length"]) == S_PROMPT + NEW


def test_engine_tokens_equal_the_reference_engine(case):
    cfg, ref_cfg, _, params, port, prompts = case
    want = RefEngine(ref_cfg, params=params).generate(prompts, max_new_tokens=NEW)
    n0 = (dict(decode_ops.LAUNCHES), dict(ssd_ops.LAUNCHES),
          dict(flash_ops.LAUNCHES))
    got = ServingEngine(cfg, params=port, device="cpu").generate(
        prompts, max_new_tokens=NEW)
    assert (decode_ops.LAUNCHES, ssd_ops.LAUNCHES, flash_ops.LAUNCHES) == n0
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.prefill_logits, np.asarray(want.prefill_logits),
                               **TOL)


def test_bf16_path_matches_the_reference_bf16_path(case):
    cfg, ref_cfg, params16, _, _, prompts = case
    port16 = mamba2.params_from_arrays(cfg, jax.tree.map(np.asarray, params16),
                                       device="cpu", dtype=torch.bfloat16)
    want_logits, _ = ref_mamba2.prefill(params16, jnp.asarray(prompts), ref_cfg)
    logits, _ = mamba2.prefill(port16, torch.from_numpy(prompts).long(), cfg)
    np.testing.assert_allclose(_np(logits), _np(want_logits), **BF16_TOL)
    want = RefEngine(ref_cfg, params=params16).generate(prompts,
                                                        max_new_tokens=NEW)
    got = ServingEngine(cfg, params=port16, device="cpu").generate(
        prompts, max_new_tokens=NEW)
    agree = float((got.tokens == want.tokens).mean())
    assert agree >= BF16_AGREE_MIN, (agree, got.tokens, want.tokens)


def test_registry_router_and_layout_answer_as_the_reference(case, monkeypatch):
    cfg, ref_cfg = case[0], case[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    api = get_model(cfg)  # no attention backend to resolve, so no card needed
    tokens = torch.from_numpy(case[5]).long()
    logits, cache = api.prefill(case[4], {"tokens": tokens})  # max_len unused
    assert int(cache["length"]) == S_PROMPT
    torch.testing.assert_close(api.forward(case[4], {"tokens": tokens})[:, -1:],
                               logits, rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ServingEngine(cfg)
    assert router.route_attention_backend(cfg) == \
        ref_router.route_attention_backend(ref_cfg) == "dense-ref"
    for max_len in (None, 100, 9000):
        for platform in (None, "cpu", "cuda"):
            plan = router.route_decode_plan(cfg, max_len, platform)
            want = ref_router.route_decode_plan(ref_cfg, max_len, "cpu")
            assert plan.attn_backend == want.attn_backend
            assert (plan.cache_layout is None) == (want.cache_layout is None)
            if plan.cache_layout is not None:
                assert plan.cache_layout.block_k == want.cache_layout.block_k
    eng = ServingEngine(cfg, params=case[4], device="cpu")
    ref_eng = RefEngine(ref_cfg, params=case[3])
    assert eng.attn_backend.name == "dense-ref"
    assert eng.cache_layout(77).block_k == ref_eng.cache_layout(77).block_k
    assert eng.cache_layout(77).padded_len(77) == ref_eng.cache_layout(77).padded_len(77)
    for fam in ("hybrid", "encdec", "vlm"):
        # the attention-bearing families resolve torch-splitk, which needs
        # a card; the ssm family above resolved none
        with pytest.raises(RuntimeError, match="CUDA device"):
            get_model(dataclasses.replace(cfg, family=fam))


def test_launcher_serves_mamba2_on_the_cpu(capsys):
    before = (dict(decode_ops.LAUNCHES), dict(ssd_ops.LAUNCHES))
    assert serve.main(["--device", "cpu", "--arch", ARCH, "--batch", "2",
                       "--prompt-len", "5", "--max-new", "3"]) == 0
    assert (decode_ops.LAUNCHES, ssd_ops.LAUNCHES) == before
    assert "[mamba2-370m] dense-ref on cpu: generated (2, 3)" in \
        capsys.readouterr().out
