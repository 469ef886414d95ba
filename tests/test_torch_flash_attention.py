"""The port's flash-attention prefill op
(``repro_torch.kernels.flash_attention``) against the JAX package's Pallas
kernel, on the same inputs made with numpy.

On the CPU the port's ``mha`` runs its plain PyTorch version; the reference
runs its Pallas kernel in interpret mode.  Tolerances are the reference's
(``tests/test_kernels.py::TestFlashAttention``): 1e-5 in fp32, where the
two sides only sum in different orders, and 2e-2 in bf16, where the output
is rounded to bf16 and the plain version rounds the probabilities to bf16
before ``p @ v`` while the kernel keeps them in fp32.
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
from repro_torch.kernels.flash_attention import ops  # noqa: E402

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


@pytest.mark.parametrize("name", sorted(
    p.parent.name for p in KERNELS.glob("*/ops.py")))
def test_ops_type_hints_resolve(name):
    """Every wrapper's annotations name what they import."""
    mod = importlib.import_module(f"repro_torch.kernels.{name}.ops")
    typing.get_type_hints(mod)
    for fn in vars(mod).values():
        if callable(fn) and getattr(fn, "__module__", None) == mod.__name__:
            typing.get_type_hints(fn)
