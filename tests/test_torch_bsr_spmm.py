"""The port's BSR SpMM layer op (``repro_torch.kernels.bsr_spmm``) against
the JAX package's Pallas kernels, on the same inputs made with numpy.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference runs its Pallas kernels in interpret mode (``bsr_spmm``, the
fleet's host lowering, and the fleet megakernel's own grid with
``force_grid=True``).  The layer op is held to 1e-5, the reference's own
tolerance (``tests/test_backends.py``): the two sides sum in different
orders.  ``tests/test_torch_kernels_gpu.py`` holds the CUDA kernels against
the plain versions on the card.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import sparse as ref_sparse  # noqa: E402
from repro.data import graphchallenge as ref_gc  # noqa: E402
from repro.kernels.bsr_spmm import ops as ref_ops  # noqa: E402
from repro.kernels.bsr_spmm.bsr_spmm import bsr_spmm_fleet_megakernel  # noqa: E402
from repro_torch.core import sparse as port_sparse  # noqa: E402
from repro_torch.core.backends import TorchBsrBackend  # noqa: E402
from repro_torch.kernels.bsr_spmm import ops, ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
BIAS = -0.3


def _cases():
    """(name, W, x): the shard cases of ``tests/test_backends.py`` —
    uniform butterfly, ragged random, a shard that is not a multiple of the
    (32, 32) block grid in either dim — plus an all-empty shard."""
    rng = np.random.default_rng(7)
    net = ref_gc.make_sparse_dnn(256, n_layers=1, seed=0)
    cases = [("butterfly-256", net.layers[0], ref_gc.make_inputs(256, 24, seed=1))]
    d = ref_sparse.random_sparse(128, 128, 8, rng).to_dense()
    d[::7] = 0.0
    cases.append(("ragged-128", ref_sparse.csr_from_dense(d),
                  rng.standard_normal((128, 16)).astype(np.float32)))
    cases.append(("odd-100x130", ref_sparse.random_sparse(100, 130, 5, rng),
                  rng.standard_normal((130, 24)).astype(np.float32)))
    empty = ref_sparse.CSRMatrix(shape=(4, 8), indptr=np.zeros(5, np.int64),
                                 indices=np.zeros(0, np.int32),
                                 data=np.zeros(0, np.float32))
    cases.append(("empty-shard", empty, np.ones((8, 3), np.float32)))
    return cases


CASES = _cases()
IDS = [c[0] for c in CASES]


def _padded(W):
    """The padded BSR operands from each package's own sparse module; the
    port's copy must build the same arrays."""
    want = ref_sparse.bsr_from_csr(W, (32, 32), pad=True)
    port_W = port_sparse.CSRMatrix(W.shape, W.indptr, W.indices, W.data)
    got = port_sparse.bsr_from_csr(port_W, (32, 32), pad=True)
    assert got.shape == want.shape
    for a, b in zip(got.padded(), want.padded()):
        np.testing.assert_array_equal(a, b)
    blocks, cols, _ = got.padded()
    return blocks.astype(np.float32), cols, got.shape[1]


def _pad_x(x, n_pad):
    xp = np.zeros((n_pad, x.shape[1]), np.float32)
    xp[: x.shape[0]] = x
    return xp


@pytest.mark.parametrize("name,W,x", CASES, ids=IDS)
def test_fused_matches_pallas_kernel(name, W, x):
    blocks, cols, n_pad = _padded(W)
    xp = _pad_x(x, n_pad)
    want = np.asarray(ref_ops.bsr_spmm(jnp.asarray(blocks), jnp.asarray(cols),
                                       jnp.asarray(xp), bias=BIAS,
                                       interpret=True))
    got = ops.bsr_spmm(torch.from_numpy(blocks), torch.from_numpy(cols),
                       torch.from_numpy(xp), bias=BIAS)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # and the layer op itself: W @ x through the epilogue
    oracle = ref_gc.relu_bias_threshold(W.matmul_dense_scatter(x), BIAS)
    np.testing.assert_allclose(got.numpy()[: W.nrows], oracle, **TOL)


def _fleet():
    """The four shard cases as one fleet of workers, at a common batch,
    stacked by the port's backend exactly as ``run_fsi`` stacks them."""
    rng = np.random.default_rng(3)
    be = TorchBsrBackend(device="cpu")
    shards = [port_sparse.CSRMatrix(W.shape, W.indptr, W.indices, W.data)
              for _, W, _ in CASES]
    states = [be.prepare(W) for W in shards]
    xs = [np.abs(rng.standard_normal((W.ncols, 20))).astype(np.float32)
          for W in shards]
    fleet = be.fleet_prepare_all([states])[0]
    X = np.zeros((len(xs), fleet.n_pad, 20), np.float32)
    for i, x in enumerate(xs):
        X[i, : x.shape[0]] = x
    return be, shards, states, xs, fleet, X


def test_fleet_matches_pallas_fleet_kernels():
    _, _, _, _, fleet, X = _fleet()
    blocks, cols, counts = (t.numpy() for t in (fleet.blocks, fleet.cols,
                                                fleet.counts))
    assert counts[-1].sum() == 0  # the empty shard is a zero-count worker
    got = ops.bsr_spmm_fleet(fleet.blocks, fleet.cols, fleet.counts,
                             torch.from_numpy(X), bias=BIAS).numpy()
    j = [jnp.asarray(a) for a in (blocks, cols, counts, X)]
    host = np.asarray(ref_ops.bsr_spmm_fleet_fused(*j, bias=BIAS,
                                                   interpret=True))
    grid = np.asarray(bsr_spmm_fleet_megakernel(*j, bias=BIAS, batch_block=20,
                                                force_grid=True))
    np.testing.assert_allclose(got, host, **TOL)
    np.testing.assert_allclose(got, grid, **TOL)


def test_fleet_apply_equals_per_worker_bitwise():
    """One fleet launch ≡ P per-worker launches, bit for bit: the fleet
    padding adds only exact zero terms."""
    be, shards, states, xs, fleet, _ = _fleet()
    got = be.fleet_apply(fleet, xs, BIAS)
    for W, st, x, y in zip(shards, states, xs, got):
        assert y.shape == (W.nrows, 20)
        np.testing.assert_array_equal(y, be.apply(st, x, BIAS))


@pytest.mark.parametrize("bad", ["dtype", "block", "contiguous", "shape",
                                 "device"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    blocks = torch.zeros((2, 3, 32, 32))
    cols = torch.zeros((2, 3), dtype=torch.int32)
    x = torch.zeros((64, 8))
    if bad == "dtype":
        cols, err = cols.long(), TypeError
    elif bad == "block":
        blocks, err = torch.zeros((2, 3, 64, 32)), ValueError
    elif bad == "contiguous":
        x, err = torch.zeros((8, 64)).t(), ValueError
    elif bad == "shape":
        cols, err = torch.zeros((2, 4), dtype=torch.int32), ValueError
    else:
        blocks, cols, x = (t.to("meta") for t in (blocks, cols, x))
        err = ValueError
    with pytest.raises(err):
        ops.bsr_spmm(blocks, cols, x, bias=BIAS)
    with pytest.raises(err):
        ops.bsr_spmm_fleet(blocks[None], cols[None],
                           torch.zeros((1, 2), dtype=torch.int32,
                                       device=x.device), x[None], bias=BIAS)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = dict(ops.LAUNCHES)
    _, _, _, _, fleet, X = _fleet()
    ops.bsr_spmm_fleet(fleet.blocks, fleet.cols, fleet.counts,
                       torch.from_numpy(X), bias=BIAS)
    assert ops.LAUNCHES == before


def test_library_path_keys_on_the_source(tmp_path, monkeypatch):
    """An edited source builds into a new directory: a stale library is
    never loaded."""
    p = ops.library_path()
    assert p.name == "libbsr_spmm.so" and p.parent.parent.name == "build"
    edited = tmp_path / "bsr_spmm.cu"
    edited.write_bytes(ops._SOURCE.read_bytes() + b"// edited\n")
    monkeypatch.setattr(ops, "_SOURCE", edited)
    q = ops.library_path()
    assert q.parent.parent == p.parent.parent and q.parent != p.parent
