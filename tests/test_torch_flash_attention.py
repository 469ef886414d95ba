"""The port's flash-attention prefill op
(``repro_torch.kernels.flash_attention``) against the JAX package's Pallas
kernel, on the same inputs made with numpy.

On the CPU the port's ``mha`` runs its plain PyTorch version; the reference
runs its Pallas kernel in interpret mode.  Tolerances are the reference's
(``tests/test_kernels.py::TestFlashAttention``): 1e-5 in fp32, where the
two sides only sum in different orders, and 2e-2 in bf16, where the output
is rounded to bf16 and the plain version rounds the probabilities to bf16
before ``p @ v`` while the kernel keeps them in fp32.
The kernel's bf16 path splits the fp32 p into three bf16 pieces for the
tensor cores; two tests hold that split's premises.
``tests/test_torch_kernels_gpu.py`` holds the CUDA kernel against the
plain version on the card.
"""

import importlib
import typing
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as ref_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"


def _inputs(B, H, KV, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, D)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, D)).astype(np.float32))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _both(arrays, dt_name, **kw):
    got = ops.mha(*(torch.from_numpy(a).to(TORCH_DT[dt_name]) for a in arrays),
                  **kw)
    want = ref_ops.mha(*(jnp.asarray(a, JAX_DT[dt_name]) for a in arrays), **kw)
    return got, want


@pytest.mark.parametrize("dt_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,S,D", [
    (2, 4, 4, 256, 64),    # MHA
    (2, 8, 2, 256, 64),    # GQA
    (1, 4, 4, 512, 128),   # longer, wide head
])
def test_mha_matches_pallas_kernel(dt_name, B, H, KV, S, D):
    n0 = ops.LAUNCHES["flash_attention"]
    got, want = _both(_inputs(B, H, KV, S, S, D, seed=S + D + H), dt_name,
                      causal=True, block_q=128, block_k=128)
    assert ops.LAUNCHES["flash_attention"] == n0  # the CPU path launches nothing
    assert got.dtype == TORCH_DT[dt_name] and tuple(got.shape) == (B, H, S, D)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt_name])


def test_non_causal_with_more_keys_than_queries():
    got, want = _both(_inputs(1, 2, 2, 128, 256, 64, seed=1), "float32",
                      causal=False)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    # causal stays top-left aligned when Sq != Sk: row 0 sees key 0 only
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 128, 256, 64, 2))
    o = ops.mha(q, k, v, causal=True)
    np.testing.assert_allclose(_np(o[:, :, 0]), _np(v[:, :, 0]), **TOL["float32"])
    want = ref_ops.mha(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                       jnp.asarray(v.numpy()), causal=True)
    np.testing.assert_allclose(_np(o), _np(want), **TOL["float32"])


def test_block_shape_invariance():
    arrays = _inputs(1, 2, 2, 512, 512, 64, seed=2)
    a = ops.mha(*(torch.from_numpy(x) for x in arrays), block_q=128, block_k=128)
    b = ops.mha(*(torch.from_numpy(x) for x in arrays), block_q=256, block_k=64)
    np.testing.assert_allclose(_np(a), _np(b), **TOL["float32"])
    want = ref_ops.mha(*(jnp.asarray(x) for x in arrays), block_q=256, block_k=64)
    np.testing.assert_allclose(_np(b), _np(want), **TOL["float32"])


def test_mha_refuses_what_the_reference_refuses():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 96, 96, 64, 0))
    with pytest.raises(TypeError, match="k is torch.bfloat16"):
        ops.mha(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="multiples of"):
        ops.mha(q, k, v, block_q=64)        # 96 % 64
    ops.mha(q, k, v, block_q=32, block_k=48)  # what the reference accepts
    with pytest.raises(ValueError, match="KV \\| H"):
        ops.mha(q[:, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        ops.mha(q.transpose(2, 3), k, v)
    # the kernel's own limits, checked on the CUDA path only
    ops.check_kernel_operands(q, k, v)
    q48, k48, v48 = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 32, 32, 48, 0))
    with pytest.raises(ValueError, match="D in \\(64, 128\\)"):
        ops.check_kernel_operands(q48, k48, v48)
    shifted = torch.empty(q.numel() + 1)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.check_kernel_operands(shifted, k, v)


def _probabilities(n, seed):
    """fp32 softmax weights as the kernel forms them, exp(s - m) in (0, 1]:
    uniform ones, exp of uniform exponents down to -87, and tiny ones."""
    rng = np.random.default_rng(seed)
    tiny = np.exp(-np.array([76.0, 80.0, 87.0, 100.0]))[:, None] * (
        1 + rng.uniform(0, 1, (4, 16)))
    return torch.from_numpy(np.concatenate([
        rng.uniform(0, 1, n), np.exp(-rng.uniform(0, 87, n)), [1.0],
        tiny.ravel()]).astype(np.float32)).clamp_min(np.float32(1e-45))


def test_three_piece_split_sums_back_to_p():
    """p = hi + mid + lo exactly for p >= 2^-110 (exp(-76) included): each
    residual is exact in fp32 and three bf16 pieces hold fp32's 24
    significand bits.  Below 2^-110 (exp(-80), exp(-100)) lo falls on
    bf16's subnormal grid, and the sum is within 2^-134 of p, far below
    any output's rounding (the row's largest p is 1)."""
    p = _probabilities(20000, seed=3)
    hi, mid, lo = ref.split_bf16(p)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    normal = p >= 2.0 ** -110
    assert normal.sum() > 30000 and (~normal).sum() > 1000
    assert torch.equal(total[normal], p.double()[normal])
    assert (total[~normal] - p.double()[~normal]).abs().max() <= 2.0 ** -134
    # the pieces shrink by at least 2^8 each, so no piece is lost to the
    # sum of the others
    assert torch.all(mid.double().abs() <= hi.double().abs() * 2.0 ** -8)
    assert torch.all(lo.double().abs() <= mid.double().abs() * 2.0 ** -8)


def test_three_piece_products_are_the_fp32_products():
    """For bf16 v, hi·v, mid·v and lo·v are each exact in fp32 (8 x 8
    significand bits), and their sum is the exact product p·v, which fp32
    arithmetic rounds once: the tensor cores' p·v is the reference's fp32
    p·v up to the order of the sums.  p >= exp(-40) and |v| >= 2^-20 keep
    every piece's product clear of fp32's subnormals."""
    p = _probabilities(20000, seed=4)
    p = p[p >= np.exp(-40.0)]
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.standard_normal(p.numel()).astype(np.float32))
    v = torch.where(v.abs() < 2.0 ** -20, torch.ones_like(v), v)
    v = v.to(torch.bfloat16).float()
    pieces = ref.split_bf16(p)
    exact = torch.zeros_like(p, dtype=torch.float64)
    for piece in pieces:
        prod = piece.float() * v
        assert torch.equal(prod.double(), piece.double() * v.double())
        exact += prod.double()
    assert torch.equal(exact, p.double() * v.double())
    # one fp32 rounding of the exact product is the reference's p·v term
    assert torch.equal(exact.float(), p * v)


# chip_smoke.py's and the GPU tests' limit on the share of a bf16 output's
# elements that equal the fp32-widened plain version rounded to bf16
EXACT_SHARE = 0.98


@pytest.mark.parametrize("causal", [True, False])
def test_exact_share_tells_an_fp32_p_from_a_rounded_one(causal):
    """The kernel's bf16 path in torch (q·kᵀ and the softmax in fp32, p·v
    as the three pieces' products summed in fp32, one rounding) keeps at
    least EXACT_SHARE of its elements equal to the fp32-widened plain
    version rounded to bf16; the bf16 plain version, which rounds p to
    bf16 before p·v, falls well under it.  So the limit fails a kernel that
    drops mid and lo."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16)
               for shape in ((1, 4, 256, 64), (1, 2, 256, 64), (1, 2, 256, 64)))
    rounded = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                      causal=causal).to(torch.bfloat16)
    kk, vv = (t.float().repeat_interleave(2, dim=1) for t in (k, v))
    s = q.float() @ kk.transpose(-1, -2) * (1.0 / np.sqrt(64))
    if causal:
        s = s.masked_fill(~torch.ones(256, 256, dtype=torch.bool).tril(), -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    pv = sum(piece.float() @ vv for piece in ref.split_bf16(p))
    kernel = (pv / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(torch.bfloat16)
    plain = ref.flash_attention_ref(q, k, v, causal=causal)
    assert (kernel == rounded).float().mean().item() >= EXACT_SHARE
    assert (plain == rounded).float().mean().item() < 0.8


@pytest.mark.parametrize("name", sorted(
    p.parent.name for p in KERNELS.glob("*/ops.py")))
def test_ops_type_hints_resolve(name):
    """Every wrapper's annotations name what they import."""
    mod = importlib.import_module(f"repro_torch.kernels.{name}.ops")
    typing.get_type_hints(mod)
    for fn in vars(mod).values():
        if callable(fn) and getattr(fn, "__module__", None) == mod.__name__:
            typing.get_type_hints(fn)
