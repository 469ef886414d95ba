"""The four phases of the chunk-parallel SSD scan kernels
(``repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu``), emulated in torch on
flat buffers on the CPU.

The emulation walks each phase's grid (``ssd_scan.cu::grid_of``) block by
block with the kernels' index arithmetic and writes the
kernels' scratch in their layouts: C·B ``[B,G,nc,Q,Q]`` once per group,
the within-chunk log-decay ``[B,H,nc,Q]``, the chunk states
``[B,H,nc,P,N]`` overwritten in place with the state passed into each
chunk (for bf16 inputs the last launch splits it into three bf16 pieces,
whose sum must give it back exactly), and y.  Every buffer starts as NaN, so an element that no block
writes shows.  Its cumsum takes the kernels' parallel form (one thread a
block of 16, then one a carry) and must equal ``mamba2.chunk_cumsum`` bit
for bit; ``clip(., -60, 0)`` comes before every ``exp``.  Products run in
fp32 on fp32-widened inputs (the kernels' bf16 products are exact on tensor
cores; only the summation order differs).  The result is held to the JAX
package's Pallas kernel in interpret mode and to the port's plain version:
y at 1e-5 and the state at 5e-5 in fp32, both at 2e-2 in bf16, and the
final state to the per-token recurrence at 1e-4.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ops as ref_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import split_bf16  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402

TILE, SCAN = 64, 16  # rows of t a block of phases a and d owns; scan block
PASS_SPAN = 1024     # state elements a block of phase c owns
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def decay(v):
    return torch.exp(torch.clamp(v, -60.0, 0.0))


def kernel_cumsum(dA):
    """The state kernel's cumsum of one chunk's ``dA [Q]``: sequential within
    blocks of 16, then each element of block k >= 1 plus carry[k], the
    in-order sum of the totals of blocks 0 .. k-1."""
    q = dA.shape[0]
    out = dA.clone()
    nb = -(-q // SCAN)
    for k in range(nb):                      # one thread a block
        for i in range(k * SCAN + 1, min(q, (k + 1) * SCAN)):
            out[i] = out[i - 1] + dA[i]
    carry = torch.zeros(nb)
    for k in range(1, nb):                   # one thread a carry
        c = out[SCAN - 1].clone()
        for j in range(1, k):
            c = c + out[j * SCAN + SCAN - 1]
        carry[k] = c
    for i in range(SCAN, q):
        out[i] = carry[i // SCAN] + out[i]
    return out


def emulate(x, dt, A, Bm, Cm, chunk):
    """The four phases on flat fp32 buffers; returns (y [B,H,L,P] in x's
    dtype, state [B,H,P,N] fp32, the scratch)."""
    B, H, L, P = x.shape
    G, N = Bm.shape[1], Bm.shape[3]
    Q, nc, rep = chunk, L // chunk, H // G
    nt = -(-Q // TILE)
    slices = -(-(P * N) // PASS_SPAN)
    xf = x.float().reshape(-1)
    bf = Bm.float().reshape(-1)
    cf = Cm.float().reshape(-1)
    dtf = dt.float().reshape(-1)
    nan = float("nan")
    cb = torch.full((B * G * nc * Q * Q,), nan)
    lbuf = torch.full((B * H * nc * Q,), nan)
    sbuf = torch.full((B * H * nc * P * N,), nan)
    state = torch.full((B * H * P * N,), nan)
    y = torch.full((B * H * L * P,), nan)

    # a. C·B over the causal tiles, one block a (b, g, chunk, tile of t)
    for blk in range(B * G * nc * nt):
        tt, bgc = blk % nt, blk // nt
        t0 = tt * TILE
        rows = min(TILE, Q - t0)
        c_rows = cf[(bgc * Q + t0) * N:(bgc * Q + t0 + rows) * N].view(rows, N)
        b_rows = bf[bgc * Q * N:(bgc * Q + min(Q, t0 + TILE)) * N].view(-1, N)
        prod = c_rows @ b_rows.T                     # s-tiles up to tt
        out = cb[bgc * Q * Q:(bgc + 1) * Q * Q].view(Q, Q)
        out[t0:t0 + rows, :prod.shape[1]] = prod

    # b. l and the chunk states, one block a (b, h, chunk)
    for bhc in range(B * H * nc):
        c, bh = bhc % nc, bhc // nc
        h, b = bh % H, bh // H
        bgc = (b * G + h // rep) * nc + c
        dtc = dtf[bhc * Q:(bhc + 1) * Q]
        ll = kernel_cumsum(dtc * A[h])
        lbuf[bhc * Q:(bhc + 1) * Q] = ll
        w = decay(ll[-1] - ll) * dtc
        xc = xf[bhc * Q * P:(bhc + 1) * Q * P].view(Q, P)
        bc = bf[bgc * Q * N:(bgc + 1) * Q * N].view(Q, N)
        sbuf[bhc * P * N:(bhc + 1) * P * N] = ((xc * w[:, None]).T @ bc).reshape(-1)

    # c. the passing, one block a (b, h, 1024 state elements), in place
    for blk in range(B * H * slices):
        bh, sl = blk // slices, blk % slices
        lo, hi = sl * PASS_SPAN, min(P * N, (sl + 1) * PASS_SPAN)
        run = torch.zeros(hi - lo)
        for c in range(nc):
            at = slice((bh * nc + c) * P * N + lo, (bh * nc + c) * P * N + hi)
            v = sbuf[at].clone()
            sbuf[at] = run
            if x.dtype == torch.bfloat16:  # d's operand: three exact pieces
                p_hi, p_mid, p_lo = (t.float() for t in split_bf16(run))
                assert torch.equal(p_hi + p_mid + p_lo, run)
            run = run * decay(lbuf[(bh * nc + c) * Q + Q - 1]) + v
        state[bh * P * N + lo:bh * P * N + hi] = run

    # d. y, one block a (b, h, chunk, tile of t), the heads of a group and
    # chunk next to one another
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    for blk in range(B * H * nc * nt):
        i = blk
        hr, i = i % rep, i // rep
        tt, i = i % nt, i // nt
        c, bg = i % nc, i // nc
        b, h = bg // G, (bg % G) * rep + hr
        bhc, bgc = (b * H + h) * nc + c, bg * nc + c
        t0 = tt * TILE
        rows = min(TILE, Q - t0)
        ll = lbuf[bhc * Q:(bhc + 1) * Q]
        lt = ll[t0:t0 + rows]
        c_rows = cf[(bgc * Q + t0) * N:(bgc * Q + t0 + rows) * N].view(rows, N)
        s_prev = sbuf[bhc * P * N:(bhc + 1) * P * N].view(P, N)
        y_x = (c_rows @ s_prev.T) * decay(lt)[:, None]
        cbt = cb[bgc * Q * Q:(bgc + 1) * Q * Q].view(Q, Q)[t0:t0 + rows]
        mask = causal[t0:t0 + rows]
        m = torch.where(mask, cbt * decay(lt[:, None] - ll[None]),
                        torch.zeros(()))
        xc = xf[bhc * Q * P:(bhc + 1) * Q * P].view(Q, P)
        xdt = xc * dtf[bhc * Q:(bhc + 1) * Q, None]
        out = m @ xdt + y_x
        y[(bhc * Q + t0) * P:(bhc * Q + t0 + rows) * P] = out.reshape(-1)

    for name, buf in (("y", y), ("state", state), ("l", lbuf), ("S", sbuf)):
        assert not bool(buf.isnan().any()), f"{name}: elements no block wrote"
    cbv = cb.view(B * G * nc, Q, Q)
    assert not bool(cbv[:, causal].isnan().any()), "CB: causal half unwritten"
    scratch = dict(cb=cbv, l=lbuf.view(B, H, nc, Q), s_prev=sbuf.view(B, H, nc, P, N))
    return (y.view(B, H, L, P).to(x.dtype), state.view(B, H, P, N), scratch)


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


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


SHAPES = [
    (2, 4, 1, 256, 32, 16, 64),     # the reference's test shapes
    (1, 4, 2, 512, 64, 32, 128),
    (2, 2, 2, 128, 32, 64, 128),    # one chunk
    (1, 6, 3, 192, 16, 8, 32),      # G 3 of H 6; 6 chunks
    (2, 4, 2, 288, 32, 16, 96),     # a chunk that is no multiple of 64
    (1, 2, 1, 512, 16, 8, 32),      # 16 chunks
]


@pytest.mark.parametrize("dt_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,G,L,P,N,chunk", SHAPES,
                         ids=["ref-1", "ref-2", "ref-3", "g3-h6", "chunk96",
                              "nc16"])
def test_phases_match_the_pallas_kernel_and_the_plain_version(
        dt_name, B, H, G, L, P, N, chunk):
    x, dt, A, Bm, Cm = _inputs(B, H, G, L, P, N, seed=L + P + N + H)
    tdt, jdt = TORCH_DT[dt_name], JAX_DT[dt_name]
    tx, tb, tc = (torch.from_numpy(a).to(tdt) for a in (x, Bm, Cm))
    y, s, _ = emulate(tx, torch.from_numpy(dt), torch.from_numpy(A), tb, tc,
                      chunk)
    assert y.dtype == tdt and tuple(s.shape) == (B, H, P, N)
    tol = TOL[dt_name]
    want_y, want_s = ref_ops.ssd(jnp.asarray(x, jdt), jnp.asarray(dt),
                                 jnp.asarray(A), jnp.asarray(Bm, jdt),
                                 jnp.asarray(Cm, jdt), chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(want_y), **tol)
    np.testing.assert_allclose(_np(s), _np(want_s), rtol=5 * tol["rtol"],
                               atol=5 * tol["atol"])
    plain_y, plain_s = ssd_scan_ref(tx, torch.from_numpy(dt),
                                    torch.from_numpy(A), tb, tc, chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(plain_y.to(tdt)), **tol)
    np.testing.assert_allclose(_np(s), _np(plain_s), rtol=5 * tol["rtol"],
                               atol=5 * tol["atol"])


@pytest.mark.parametrize("chunk", [16, 40, 96, 256])
def test_kernel_cumsum_is_chunk_cumsum_bit_for_bit(chunk):
    rng = np.random.default_rng(chunk)
    dA = torch.from_numpy(-_softplus(rng.standard_normal(chunk))
                          * np.float32(np.exp(0.3 * rng.standard_normal())))
    assert torch.equal(kernel_cumsum(dA), mamba2.chunk_cumsum(dA[None])[0])


def test_scratch_holds_cb_once_per_group_and_the_passed_states():
    """C·B is stored per (b, g, chunk), shared by the H / G heads; the chunk
    states hold S_prev, the state passed into each chunk (zero for the
    first); the passing reproduces the plain version's recurrence."""
    B, H, G, L, P, N, chunk = 1, 4, 2, 256, 16, 8, 64
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in
                        _inputs(B, H, G, L, P, N, seed=3))
    _, s, scratch = emulate(x, dt, A, Bm, Cm, chunk)
    nc = L // chunk
    cb = scratch["cb"].view(B, G, nc, chunk, chunk)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    for g in range(G):
        for c in range(nc):
            rows = slice(c * chunk, (c + 1) * chunk)
            want = Cm[0, g, rows] @ Bm[0, g, rows].T
            torch.testing.assert_close(cb[0, g, c][causal], want[causal],
                                       rtol=1e-5, atol=1e-5)
    s_prev = scratch["s_prev"]
    assert torch.equal(s_prev[:, :, 0], torch.zeros_like(s_prev[:, :, 0]))
    for c in range(1, nc):  # S_prev of chunk c: the scan's state at its start
        _, want = ssd_scan_ref(x[:, :, :c * chunk].contiguous(), dt[:, :, :c * chunk],
                               A, Bm[:, :, :c * chunk].contiguous(),
                               Cm[:, :, :c * chunk].contiguous(), chunk=chunk)
        torch.testing.assert_close(s_prev[:, :, c], want, rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_final_state_matches_the_sequential_recurrence(chunk):
    B, H, G, L, P, N = 1, 2, 1, 256, 16, 8
    x, dt, A, Bm, Cm = _inputs(B, H, G, L, P, N, seed=chunk)
    _, s, _ = emulate(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk)
    want = np.zeros((B, H, P, N), np.float32)
    for t in range(L):
        a = np.exp(dt[:, :, t] * A[None])
        want = want * a[..., None, None] + np.einsum(
            "bh,bn,bhp->bhpn", dt[:, :, t], Bm[:, 0, t], x[:, :, t])
    np.testing.assert_allclose(_np(s), want, rtol=1e-4, atol=1e-4)

