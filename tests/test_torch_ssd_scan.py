"""The port's chunked SSD scan (``repro_torch.kernels.ssd_scan``) and the
Mamba-2 pieces it rests on (``repro_torch.models.mamba2``) against the JAX
package, on the same inputs made with numpy.

On the CPU the port's ``ssd`` runs its plain PyTorch version; the reference
runs its Pallas kernel in interpret mode.  Tolerances are the reference's
(``tests/test_kernels.py::TestSsdScan``): y at 1e-5 in fp32 and 2e-2 in bf16
(y is rounded to bf16), the final state at five times that (it sums a whole
sequence of chunk states, and the two sides take the within-chunk cumsum
in different orders), and the final state against a sequential per-token
recurrence at 1e-4.  The model pieces (``ssd_chunked`` with a carried
state and a padded last chunk, ``ssd_decode``, ``causal_conv`` with and
without a carried tail) are held to the JAX functions at 1e-5 in fp32.
``tests/test_torch_kernels_gpu.py`` holds the CUDA kernel against the plain
version on the card.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ops as ref_ops  # noqa: E402
from repro.models import mamba2 as ref_mamba2  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
FP32 = dict(rtol=1e-5, atol=1e-5)


def _softplus(a):
    return np.log1p(np.exp(a)).astype(np.float32)


def _inputs(B, H, G, L, P, N, seed):
    """The reference's recipe: x, B, C normal; dt = softplus(normal);
    A = -exp(0.3 normal)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, H, L, P)).astype(f),
            _softplus(rng.standard_normal((B, H, L))),
            -np.exp(0.3 * rng.standard_normal(H)).astype(f),
            rng.standard_normal((B, G, L, N)).astype(f),
            rng.standard_normal((B, G, L, N)).astype(f))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dt_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,G,L,P,N,chunk", [
    (2, 4, 1, 256, 32, 16, 64),
    (1, 4, 2, 512, 64, 32, 128),
    (2, 2, 2, 128, 32, 64, 128),   # single chunk
])
def test_ssd_matches_pallas_kernel(dt_name, B, H, G, L, P, N, chunk):
    x, dt, A, Bm, Cm = _inputs(B, H, G, L, P, N, seed=L + P + N)
    tdt, jdt = TORCH_DT[dt_name], JAX_DT[dt_name]
    n0 = ops.LAUNCHES["ssd_scan"]
    y, s = ops.ssd(torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
                   torch.from_numpy(A), torch.from_numpy(Bm).to(tdt),
                   torch.from_numpy(Cm).to(tdt), chunk=chunk)
    assert ops.LAUNCHES["ssd_scan"] == n0  # the CPU path launches nothing
    assert y.dtype == tdt and s.dtype == torch.float32
    assert tuple(y.shape) == (B, H, L, P) and tuple(s.shape) == (B, H, P, N)
    want_y, want_s = ref_ops.ssd(jnp.asarray(x, jdt), jnp.asarray(dt),
                                 jnp.asarray(A), jnp.asarray(Bm, jdt),
                                 jnp.asarray(Cm, jdt), chunk=chunk)
    tol = TOL[dt_name]
    np.testing.assert_allclose(_np(y), _np(want_y), **tol)
    np.testing.assert_allclose(_np(s), _np(want_s), rtol=5 * tol["rtol"],
                               atol=5 * tol["atol"])


def test_final_state_matches_the_sequential_recurrence():
    B, H, G, L, P, N = 1, 2, 1, 64, 16, 8
    x, dt, A, Bm, Cm = _inputs(B, H, G, L, P, N, seed=7)
    _, s = ops.ssd(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk=32)
    want = np.zeros((B, H, P, N), np.float32)
    for t in range(L):
        a = np.exp(dt[:, :, t] * A[None])
        want = want * a[..., None, None] + np.einsum(
            "bh,bn,bhp->bhpn", dt[:, :, t], Bm[:, 0, t], x[:, :, t])
    np.testing.assert_allclose(_np(s), want, rtol=1e-4, atol=1e-4)


def test_ssd_chunked_with_init_state_and_a_padded_chunk():
    """L = 45 over chunks of 16 (the last padded), G = 2 of H = 4, and a
    carried state."""
    rng = np.random.default_rng(3)
    B, L, H, P, G, N, chunk = 2, 45, 4, 8, 2, 4, 16
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = _softplus(rng.standard_normal((B, L, H)))
    A = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    for init in (None, s0):
        y, s = mamba2.ssd_chunked(
            *(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk,
            init_state=None if init is None else torch.from_numpy(init))
        want_y, want_s = ref_mamba2.ssd_chunked(
            *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk,
            init_state=None if init is None else jnp.asarray(init))
        assert tuple(y.shape) == (B, L, H, P)
        np.testing.assert_allclose(_np(y), _np(want_y), **FP32)
        np.testing.assert_allclose(_np(s), _np(want_s), **FP32)


def test_ssd_decode_matches():
    rng = np.random.default_rng(4)
    B, H, P, G, N = 3, 4, 8, 2, 4
    args = (rng.standard_normal((B, 1, H, P)).astype(np.float32),
            _softplus(rng.standard_normal((B, 1, H))),
            -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32),
            rng.standard_normal((B, 1, G, N)).astype(np.float32),
            rng.standard_normal((B, 1, G, N)).astype(np.float32),
            rng.standard_normal((B, H, P, N)).astype(np.float32))
    y, s = mamba2.ssd_decode(*(torch.from_numpy(a) for a in args))
    want_y, want_s = ref_mamba2.ssd_decode(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(_np(y), _np(want_y), **FP32)
    np.testing.assert_allclose(_np(s), _np(want_s), **FP32)


@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv_matches(carried):
    rng = np.random.default_rng(5 + carried)
    B, L, C, K = 2, 7, 6, 4
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    w = rng.standard_normal((K, C)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    st = rng.standard_normal((B, K - 1, C)).astype(np.float32) if carried else None
    y, new = mamba2.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b),
                                None if st is None else torch.from_numpy(st))
    want_y, want_new = ref_mamba2.causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    np.testing.assert_allclose(_np(y), _np(want_y), **FP32)
    np.testing.assert_array_equal(_np(new), _np(want_new))


def test_ssd_refuses_what_the_reference_refuses():
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in
                        _inputs(1, 4, 2, 96, 16, 8, seed=0))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd(x, dt, A, Bm, Cm, chunk=64)
    with pytest.raises(TypeError, match="Bm is torch.bfloat16"):
        ops.ssd(x, dt, A, Bm.bfloat16(), Cm, chunk=32)
    with pytest.raises(ValueError, match="G \\| H"):
        ops.ssd(x[:, :3].contiguous(), dt[:, :3], A[:3], Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="dt must be"):
        ops.ssd(x, dt[:, :, :-1], A, Bm, Cm, chunk=32)
    # dt and A are cast to fp32, as the TPU kernel casts them
    y64, _ = ops.ssd(x, dt.double(), A.double(), Bm, Cm, chunk=32)
    y32, _ = ops.ssd(x, dt, A, Bm, Cm, chunk=32)
    assert torch.equal(y64, y32)
    np.testing.assert_array_equal(
        _np(y32), _np(ssd_scan_ref(x, dt, A, Bm, Cm, chunk=32)[0]))
    # the kernel's own limits, checked on the CUDA path only
    ops.check_kernel_operands(x, Bm, 32)
    with pytest.raises(ValueError, match=r"\(P, N\) in"):
        ops.check_kernel_operands(x[..., :12], Bm, 32)
    with pytest.raises(ValueError, match="chunk <="):
        ops.check_kernel_operands(x, Bm, 2048)
