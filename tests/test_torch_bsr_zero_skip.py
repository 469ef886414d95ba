"""The zero-skipping walk of the BSR kernels (``kernels/bsr_spmm/csrc/
bsr_spmm.cu``), emulated element by element in numpy fp32 on the CPU.

The kernels accumulate each output in ascending k, then ascending j, with
one ``fmaf`` a term, and skip the terms whose weight is zero, except in a
block whose x slice (its bn rows of x, the batch tile's columns) holds an
Inf or a NaN, which they walk over every term.  The emulation holds that
walk to the walk over every term (bit for bit, on the GraphChallenge block
patterns with signed x, weights and bias, and with Inf, -Inf or NaN in x's
column blocks 1 and up, NaN in the same places), to the JAX package's
Pallas kernel (interpret mode, 1e-5, the reference's layer-op tolerance),
and shows the one way the two walks part on finite x: an underflow to -0,
which the epilogue erases.  The port's plain versions are held to the
reference's on non-finite x (NaN in the same places, the rest at 1e-5).
``ops.layer_work``'s counts are checked on layers whose nonzeros are known.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from repro.core import sparse as ref_sparse
from repro.data import graphchallenge as ref_gc
from repro_torch.kernels.bsr_spmm import ops, ref

TOL = dict(rtol=1e-5, atol=1e-5)
CLIP = np.float32(32.0)


def fma32(a, b, c):
    """``fmaf(a, b, c)`` on float32 arrays, rounded once: a*b is exact in
    float64 (two 24-bit significands), the float64 sum is rounded to odd
    (the exact error of the round-to-nearest sum, by TwoSum, says which
    way), and a sum rounded to odd with 53 >= 24 + 2 bits rounds to the
    float32 nearest the exact value."""
    with np.errstate(invalid="ignore", over="ignore"):  # Inf and NaN terms
        p = a.astype(np.float64) * b.astype(np.float64)
        c = c.astype(np.float64)
        s = p + c
        bb = s - p
        err = (p - (s - bb)) + (c - bb)
        even = (s.view(np.int64) & 1) == 0
        s = np.where((err != 0) & even,
                     np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
        return s.astype(np.float32)


def _round_exact(q: Fraction) -> np.float32:
    """The float32 nearest the rational q, ties to even."""
    f = np.float32(float(q))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - q),
                                     int(np.array(v).view(np.uint32)) & 1))


TILE_B = 128  # batch columns a block of the kernels owns


def walk(blocks, cols, x, skip: bool, dense_if_nonfinite: bool = False):
    """The kernel's walk over one worker-layer: ``blocks [NBR,K,bm,bn]``,
    ``cols [NBR,K]``, ``x [N,B]`` → the accumulators ``[NBR,bm,B]`` and
    whether one of them was ever -0.  With ``skip`` only the nonzero
    weights' terms are taken; with ``dense_if_nonfinite`` too, every term of
    a block whose x slice (its bn rows, the batch tile's 128 columns) holds
    an Inf or a NaN, as the kernels take them."""
    nbr, k, bm, bn = blocks.shape
    b = x.shape[1]
    acc = np.zeros((nbr, bm, b), np.float32)
    tile = np.arange(b) // TILE_B
    minus_zero = False
    for kk in range(k):
        rows = cols[:, kk].astype(np.int64) * bn
        bad = ~np.isfinite(x[rows[:, None] + np.arange(bn)])   # [NBR, bn, B]
        flag = np.zeros((nbr, b), bool)                         # per block
        for t in np.unique(tile):
            flag[:, tile == t] = bad[:, :, tile == t].any(axis=(1, 2))[:, None]
        for j in range(bn):
            w = np.broadcast_to(blocks[:, kk, :, j][..., None], acc.shape)
            xr = np.broadcast_to(x[rows + j][:, None, :], acc.shape)
            new = fma32(w, xr, acc)
            take = w != 0
            if dense_if_nonfinite:
                take = take | flag[:, None, :]
            acc = np.where(take, new, acc) if skip else new
            minus_zero |= bool(np.any((acc == 0) & np.signbit(acc)))
    return acc, minus_zero


def epilogue(acc, bias):
    """The kernels' store: every zero and negative sum stores +0; NaN stays
    NaN, as in the plain version's clamp."""
    v = acc + np.float32(bias)
    return np.where(np.isnan(v), v,
                    np.minimum(np.where(v > 0, v, np.float32(0)), CLIP))


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _same_bits_and_nans(a, b):
    """NaN in the same places and every other element equal bit for bit."""
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    np.testing.assert_array_equal(nan_a, nan_b)
    np.testing.assert_array_equal(_bits(a)[~nan_a], _bits(b)[~nan_b])


def _padded(W):
    blocks, cols, counts = ref_sparse.bsr_from_csr(W, (32, 32), pad=True).padded()
    return blocks.astype(np.float32), cols, counts


def test_fma32_rounds_once():
    # exact sum just below the tie between 1 + 2^-23 and 1 + 2^-22: rounding
    # it to float64 first lands on the tie, which then rounds up to even
    a = np.float32(1 + 2.0**-18)
    b = np.float32(2.0**-24 * (1 - 2.0**-18))
    c = np.float32(1 + 2.0**-23)
    got = fma32(np.array([a]), np.array([b]), np.array([c]))[0]
    assert got == c
    assert np.float32(np.float64(a) * np.float64(b) + np.float64(c)) != c
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(400).astype(np.float32)
               * np.float32(2.0) ** rng.integers(-30, 30, 400).astype(np.float32)
               for _ in range(3))
    got = fma32(a, b, c)
    for i in range(400):
        want = _round_exact(Fraction(float(a[i])) * Fraction(float(b[i]))
                            + Fraction(float(c[i])))
        assert got[i] == want, (a[i], b[i], c[i])


def _pattern_layer(layer: int):
    """Layer 0, 1 or 2 of the N = 2048 net: window offsets 0, 3 and 6, the
    three block patterns of the GraphChallenge nets in 32x32 BSR (dense
    blocks, 4 nonzeros a block row, 1)."""
    return ref_gc.make_sparse_dnn(2048, n_layers=3, seed=0).layers[layer]


@pytest.mark.parametrize("values", ["graphchallenge", "signed"])
@pytest.mark.parametrize("layer,per_row", [(0, 32), (1, 4), (2, 1)],
                         ids=["dense", "four-a-row", "one-a-row"])
def test_skipping_zero_terms_keeps_every_bit(layer, per_row, values):
    blocks, cols, counts = _padded(_pattern_layer(layer))
    nz = blocks != 0
    assert nz.sum(-1).max() == per_row and nz[..., 0, :].any()
    rng = np.random.default_rng(layer)
    if values == "signed":
        blocks = np.where(nz, rng.standard_normal(blocks.shape), 0).astype(np.float32)
    x = rng.standard_normal((cols.max() * 32 + 32, 8)).astype(np.float32)
    full, full_m0 = walk(blocks, cols, x, skip=False)
    skip, skip_m0 = walk(blocks, cols, x, skip=True)
    np.testing.assert_array_equal(_bits(skip), _bits(full))
    assert not full_m0 and not skip_m0
    for bias in (-0.3, 0.2):
        np.testing.assert_array_equal(_bits(epilogue(skip, bias)),
                                      _bits(epilogue(full, bias)))


def _nonfinite_x(n_rows, b, value, rng, signed=True, count=6):
    """Normal x [n_rows, b] (its absolute value unless ``signed``, as the
    FSI's x is non-negative) with ``count`` entries set to ``value`` in
    column blocks 1 and up (rows 32 and past: the padding slots of the
    padded layout reference column block 0)."""
    x = rng.standard_normal((n_rows, b)).astype(np.float32)
    if not signed:
        x = np.abs(x)
    x[rng.integers(32, n_rows, count), rng.integers(0, b, count)] = np.float32(value)
    return x


@pytest.mark.parametrize("value", ["inf", "-inf", "nan"])
@pytest.mark.parametrize("layer,per_row", [(0, 32), (1, 4), (2, 1)],
                         ids=["dense", "four-a-row", "one-a-row"])
def test_nonfinite_x_takes_the_dense_walk_bit_for_bit(layer, per_row, value):
    """With an Inf, -Inf or NaN in x, the kernels' walk (skip zero weights,
    but walk a block whose x slice holds one over every term) equals the
    walk over every term bit for bit, NaN in the same places, before and
    after the epilogue; the skipping walk alone loses NaN where a zero
    weight meets an Inf or a NaN."""
    blocks, cols, counts = _padded(_pattern_layer(layer))
    rng = np.random.default_rng(20 + layer)
    blocks = np.where(blocks != 0, rng.standard_normal(blocks.shape),
                      0).astype(np.float32)
    x = _nonfinite_x(cols.max() * 32 + 32, 8, value, rng)
    full, _ = walk(blocks, cols, x, skip=False)
    kern, _ = walk(blocks, cols, x, skip=True, dense_if_nonfinite=True)
    _same_bits_and_nans(kern, full)
    for bias in (-0.3, 0.2):
        _same_bits_and_nans(epilogue(kern, bias), epilogue(full, bias))
    skip, _ = walk(blocks, cols, x, skip=True)
    if per_row < 32:  # zero weights over the non-finite rows
        assert np.isnan(skip).sum() < np.isnan(full).sum()
    else:             # no zero weight: nothing is skipped
        _same_bits_and_nans(skip, full)


@pytest.mark.parametrize("value", ["inf", "-inf", "nan"])
def test_plain_versions_match_the_reference_on_nonfinite_x(value):
    """The port's plain versions against the JAX package's Pallas kernel
    (interpret mode) and ``_fleet_host_lowering``, and the kernels' walk
    against the port's plain version, on x with Inf, -Inf or NaN in column
    blocks 1 and up: NaN in the same places, the rest at 1e-5.  The fleet:
    layers 1 and 2 of the N = 2048 net (K 8 and 32), the first padded to K
    32 with all-zero slots that reference column block 0."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.bsr_spmm import ops as ref_ops
    from repro.kernels.bsr_spmm.bsr_spmm import _fleet_host_lowering

    net = ref_gc.make_sparse_dnn(2048, n_layers=3, seed=0)
    rng = np.random.default_rng(7)
    x = _nonfinite_x(2048, 16, value, rng, signed=False)
    bias = net.bias
    blocks, cols, counts = _padded(net.layers[1])
    got = ref.bsr_spmm_fused_ref(torch.from_numpy(blocks), torch.from_numpy(cols),
                                 torch.from_numpy(x), bias).numpy()
    want = np.asarray(ref_ops.bsr_spmm(jnp.asarray(blocks), jnp.asarray(cols),
                                       jnp.asarray(x), bias=bias, interpret=True))
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **TOL)
    acc, _ = walk(blocks, cols, x, skip=True, dense_if_nonfinite=True)
    kern = epilogue(acc, bias).reshape(got.shape)
    np.testing.assert_array_equal(np.isnan(kern), np.isnan(got))
    np.testing.assert_allclose(kern, got, **TOL)

    layers = [_padded(net.layers[i]) for i in (1, 2)]
    k = max(bl.shape[1] for bl, _, _ in layers)
    fb = np.zeros((2, layers[0][0].shape[0], k, 32, 32), np.float32)
    fc = np.zeros((2, layers[0][0].shape[0], k), np.int32)
    fn = np.zeros((2, layers[0][0].shape[0]), np.int32)
    for m, (bl, co, cn) in enumerate(layers):
        fb[m, :, :bl.shape[1]], fc[m, :, :co.shape[1]], fn[m] = bl, co, cn
    fx = np.stack([x, _nonfinite_x(2048, 16, value, rng, signed=False)])
    got = ref.bsr_spmm_fleet_ref(*(torch.from_numpy(a) for a in (fb, fc, fn, fx)),
                                 bias).numpy()
    want = np.asarray(_fleet_host_lowering(jnp.asarray(fb), jnp.asarray(fc),
                                           jnp.asarray(fx), bias, 32.0))
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **TOL)


def test_an_underflow_to_minus_zero_is_erased_by_the_epilogue():
    """The walks part only in the sign of a zero: -2^-100 * 2^-100 rounds
    to -0, and the full walk's next term, an exact +0, turns it into +0.
    The stored outputs are equal bit for bit."""
    blocks = np.zeros((1, 1, 1, 2), np.float32)
    blocks[0, 0, 0, 0] = -(2.0**-100)
    cols = np.zeros((1, 1), np.int32)
    x = np.array([[2.0**-100], [1.0]], np.float32)
    full, full_m0 = walk(blocks, cols, x, skip=False)
    skip, skip_m0 = walk(blocks, cols, x, skip=True)
    assert full_m0 and skip_m0
    assert full[0, 0, 0] == skip[0, 0, 0] == 0
    assert not np.signbit(full[0, 0, 0]) and np.signbit(skip[0, 0, 0])
    for bias in (0.0, -0.0, -1.0):
        np.testing.assert_array_equal(_bits(epilogue(skip, bias)),
                                      _bits(epilogue(full, bias)))
        assert _bits(epilogue(skip, bias))[0, 0, 0] == 0


@pytest.mark.parametrize("n,layer", [(1024, 0), (1024, 1), (1024, 2),
                                     (1024, 3), (2048, 2)],
                         ids=["1024-l0", "1024-l1", "1024-l2", "1024-l3",
                              "2048-l2"])
def test_zero_skipping_walk_matches_the_pallas_kernel(n, layer):
    """The first four layers of the N = 1024 net (window offsets 0, 3, 6, 9,
    which fold to 0, 3, 0, 3 at N = 1024) and, for the one-nonzero pattern,
    layer 2 of the N = 2048 net."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.bsr_spmm import ops as ref_ops

    net = ref_gc.make_sparse_dnn(n, n_layers=layer + 1, seed=0)
    blocks, cols, _ = _padded(net.layers[layer])
    x = ref_gc.make_inputs(n, 16, seed=1)
    acc, _ = walk(blocks, cols, x, skip=True)
    got = epilogue(acc, net.bias).reshape(-1, x.shape[1])
    want = np.asarray(ref_ops.bsr_spmm(jnp.asarray(blocks), jnp.asarray(cols),
                                       jnp.asarray(x), bias=net.bias,
                                       interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


def test_layer_work_counts_the_nonzeros_of_the_real_blocks():
    # layer 2 of the N = 2048 net: 64 row blocks of 32 real blocks, one
    # nonzero a block row; every column block referenced
    blocks, cols, counts = _padded(_pattern_layer(2))
    t = [torch.from_numpy(a) for a in (blocks, cols, counts.astype(np.int32))]
    nbytes, flops = ops.layer_work(*t, 128)
    assert flops == 2 * 2048 * 32 * 128
    assert nbytes == (64 * 32 * (32 * 32 + 1) + 64 + 64 * 32 * 128
                      + 2048 * 128) * 4
    # a fleet of two workers, 2x2 blocks: worker 0's row 0 has 2 real
    # blocks, row 1 one; worker 1's row 0 none; the slots past the counts
    # hold nonzeros that the kernels never read and the count skips
    blocks = torch.zeros((2, 2, 3, 2, 2))
    blocks[0, 0, 0] = torch.tensor([[1.0, 0.0], [0.0, 2.0]])   # 2 nonzeros
    blocks[0, 0, 1] = torch.tensor([[1.0, 1.0], [1.0, 0.0]])   # 3
    blocks[0, 1, 0] = torch.tensor([[0.0, 0.0], [0.0, -1.0]])  # 1
    blocks[0, 1, 2] = 5.0                                       # padding
    blocks[1, 0, 0] = 7.0                                       # padding
    blocks[1, 1, :2] = 1.0                                      # 2 x 4
    cols = torch.tensor([[[0, 1, 0], [1, 0, 0]], [[0, 0, 0], [2, 2, 0]]],
                        dtype=torch.int32)
    counts = torch.tensor([[2, 1], [0, 2]], dtype=torch.int32)
    nbytes, flops = ops.layer_work(blocks, cols, counts, 5)
    assert flops == 2 * (2 + 3 + 1 + 8) * 5
    real_blocks, x_blocks = 5, 3        # x blocks (0, 0), (0, 1), (1, 2)
    assert nbytes == (real_blocks * (4 + 1) + 4 + x_blocks * 2 * 5
                      + 2 * 2 * 2 * 5) * 4
