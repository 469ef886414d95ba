"""The CUDA BSR SpMM kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA card and skips where there is none; run
them on one with ``python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.

The file imports only torch, numpy and the port (no JAX), so it runs where
the JAX package is not installed.  Tolerance 1e-5 for the kernel against the
plain version (they sum in different orders); the fleet kernel must equal
the per-worker kernel bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.backends import TorchBsrBackend
from repro_torch.core.sparse import CSRMatrix, csr_from_dense, random_sparse
from repro_torch.data.graphchallenge import make_inputs, make_sparse_dnn
from repro_torch.kernels.bsr_spmm import ops, ref

pytestmark = pytest.mark.gpu

TOL = dict(rtol=1e-5, atol=1e-5)
BIAS = -0.3


def _shards():
    """Worker shards: a butterfly layer at window offset 6 (K = 32 blocks a
    row block), a ragged random shard, one that is not a multiple of the
    32x32 block grid, and an empty one (a zero-count worker)."""
    rng = np.random.default_rng(7)
    d = random_sparse(128, 128, 8, rng).to_dense()
    d[::7] = 0.0
    empty = CSRMatrix(shape=(4, 8), indptr=np.zeros(5, np.int64),
                      indices=np.zeros(0, np.int32),
                      data=np.zeros(0, np.float32))
    return [make_sparse_dnn(1024, n_layers=3, seed=0).layers[2],
            csr_from_dense(d), random_sparse(100, 130, 5, rng), empty]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.fixture
def fleet(cuda):
    """The shards stacked as ``run_fsi`` stacks a fleet, on the card, with a
    ragged batch (200 = one full 128-column tile and a partial one)."""
    be = TorchBsrBackend(device="cuda")
    states = [be.prepare(W) for W in _shards()]
    f = be.fleet_prepare_all([states])[0]
    g = np.random.default_rng(1)
    x = torch.from_numpy(g.uniform(0, 2, (len(states), f.n_pad, 200))
                         .astype(np.float32)).to(cuda)
    return f, x


@pytest.mark.parametrize("batch", [128, 24, 200])
def test_fused_kernel_matches_plain(cuda, fleet, batch):
    f, x = fleet
    for p in range(x.shape[0]):
        args = (f.blocks[p], f.cols[p], x[p, :, :batch].contiguous())
        n0 = ops.LAUNCHES["bsr_spmm_fused"]
        got = ops.bsr_spmm(*args, bias=BIAS)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["bsr_spmm_fused"] == n0 + 1
        torch.testing.assert_close(got, ref.bsr_spmm_fused_ref(*args, BIAS), **TOL)


def test_fleet_kernel_matches_plain_and_per_worker(cuda, fleet):
    f, x = fleet
    assert int(f.counts[-1].sum()) == 0
    n0 = ops.LAUNCHES["bsr_spmm_fleet"]
    got = ops.bsr_spmm_fleet(f.blocks, f.cols, f.counts, x, bias=BIAS)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["bsr_spmm_fleet"] == n0 + 1
    torch.testing.assert_close(
        got, ref.bsr_spmm_fleet_ref(f.blocks, f.cols, f.counts, x, BIAS), **TOL)
    for p in range(x.shape[0]):
        assert torch.equal(got[p], ops.bsr_spmm(f.blocks[p], f.cols[p], x[p],
                                                bias=BIAS))
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))


def test_backend_apply_on_the_card_matches_cpu(cuda):
    W = make_sparse_dnn(1024, n_layers=1, seed=0).layers[0]
    x = make_inputs(1024, 128, seed=1)
    gpu, cpu = TorchBsrBackend(device="cuda"), TorchBsrBackend(device="cpu")
    np.testing.assert_allclose(gpu.apply(gpu.prepare(W), x, BIAS),
                               cpu.apply(cpu.prepare(W), x, BIAS), **TOL)


def test_wrappers_raise_on_mixed_devices_and_wide_blocks(cuda):
    x = torch.zeros((64, 8), device=cuda)
    with pytest.raises(ValueError, match="expected"):
        ops.bsr_spmm(torch.zeros((2, 3, 32, 32)),
                     torch.zeros((2, 3), dtype=torch.int32, device=cuda), x,
                     bias=BIAS)
    with pytest.raises(ValueError, match="block shape"):
        ops.bsr_spmm(torch.zeros((2, 3, 64, 32), device=cuda),
                     torch.zeros((2, 3), dtype=torch.int32, device=cuda), x,
                     bias=BIAS)
