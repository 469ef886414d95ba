"""Public names of the JAX package that the port adds beside its main
paths, held to the reference on the CPU:

* ``serving/router.py``: ``route_serverless`` and ``ServerlessRoute`` over
  ``core/cost_model.recommend_configuration``, on a grid of request
  profiles (model bytes, exchange bytes a layer, depth, worker memory);
* ``configs``: ``get_config("sparse-dnn-graphchallenge")`` field for
  field, and ``list_archs`` (the language models only);
* ``kernels/bsr_spmm``: ``prepare_bsr_operands``, ``sparse_layer_apply``
  (the plain version of the ``bsr_spmm`` kernel on the CPU; the kernel on
  the card is ``chip_smoke.py``'s) within 1e-5 of the reference's Pallas
  kernel in interpret mode, and ``ref.bsr_to_dense`` exactly;
  ``bsr_spmm_fleet_fused``, the reference's name and signature for the
  one-launch fleet op (the port's ``bsr_spmm_fleet``), within 1e-5 of the
  reference's;
* ``kernels/decode_attention``: ``decode_mha_cache_size``, the launch
  plans cached (0 after the plain version's calls, which plan nothing;
  ``chip_smoke.py`` checks on the card that ten growing cache lengths add
  no plan, as the reference's test does for its jit cache).
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import list_archs as ref_list_archs  # noqa: E402
from repro.core import sparse as ref_sparse  # noqa: E402
import inspect  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.kernels.bsr_spmm import ops as ref_ops  # noqa: E402
from repro.kernels.decode_attention import ops as ref_decode_ops  # noqa: E402
from repro.kernels.bsr_spmm import ref as ref_bsr_ref  # noqa: E402
from repro.serving import router as ref_router  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core import sparse  # noqa: E402
from repro_torch.kernels.bsr_spmm import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.serving import router  # noqa: E402
from _port_keys import as_port  # noqa: E402

GRID = list(itertools.product(
    (10**6, 6 * 10**8, 3 * 10**9, 2 * 10**10),   # model bytes
    (0.0, 4096.0, 1.3e6, 8e7),                  # exchange bytes a layer
    (1, 12, 120),                               # layers
    (1024, 4000, 10240)))                       # MB a worker


@pytest.mark.parametrize("memory_mb", (1024, 4000, 10240))
def test_route_serverless_matches_the_reference(memory_mb):
    seen = set()
    for model_bytes, exchange, layers, mem in GRID:
        if mem != memory_mb:
            continue
        got = router.route_serverless(model_bytes, exchange, layers,
                                      memory_mb=mem)
        want = ref_router.route_serverless(model_bytes, exchange, layers,
                                           memory_mb=mem)
        assert isinstance(got, router.ServerlessRoute)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (
            model_bytes, exchange, layers, mem)
        seen.add(got.channel)
    assert len(seen) >= 2, seen   # the grid reaches more than one channel
    assert router.route_serverless(10**6, 0.0, 1) == router.ServerlessRoute(
        **dataclasses.asdict(ref_router.route_serverless(10**6, 0.0, 1)))


def test_sparse_dnn_config_and_arch_list_match_the_reference():
    got = get_config("sparse-dnn-graphchallenge")
    want = ref_get_config("sparse-dnn-graphchallenge")
    assert dataclasses.asdict(got) == as_port(want)
    assert sorted(list_archs()) == sorted(ref_list_archs())
    assert "sparse-dnn-graphchallenge" not in list_archs()


def _bsr(seed: int, n: int, block: int, density: float):
    rng = np.random.default_rng(seed)
    dense = (rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
             ).astype(np.float32)
    dense[: block, :] = 0.0          # an empty block row
    return (dense, sparse.bsr_from_dense(dense, (block, block)),
            ref_sparse.bsr_from_dense(dense, (block, block)))


@pytest.mark.parametrize("seed,n,block,density,batch",
                         [(0, 64, 8, 0.1, 16), (1, 96, 32, 0.05, 24),
                          (2, 40, 4, 0.3, 3)])
def test_sparse_layer_apply_matches_the_reference(seed, n, block, density, batch):
    dense, bsr, ref_bsr = _bsr(seed, n, block, density)
    x = np.abs(np.random.default_rng(seed + 10).standard_normal(
        (n, batch))).astype(np.float32) * 8
    blocks, cols = ops.prepare_bsr_operands(bsr, device="cpu")
    want_blocks, want_cols = ref_ops.prepare_bsr_operands(ref_bsr)
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(want_blocks))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(want_cols))
    assert blocks.dtype == torch.float32 and cols.dtype == torch.int32
    np.testing.assert_array_equal(
        ref.bsr_to_dense(blocks.numpy(), cols.numpy(), n // block), dense)
    np.testing.assert_array_equal(
        ref.bsr_to_dense(blocks.numpy(), cols.numpy(), n // block),
        ref_bsr_ref.bsr_to_dense(np.asarray(want_blocks), np.asarray(want_cols),
                                 n // block))
    launches = dict(ops.LAUNCHES)
    for bias, clip in ((-0.3, 32.0), (0.5, 4.0)):
        got = ops.sparse_layer_apply(bsr, x, bias, clip=clip, device="cpu")
        want = ref_ops.sparse_layer_apply(ref_bsr, x, bias, clip=clip)
        assert got.shape == (n, batch) and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            got.numpy(), np.clip(dense @ x + bias, 0.0, clip), rtol=1e-5,
            atol=1e-5)
    assert ops.LAUNCHES == launches   # the CPU launches no kernel
    torch_x = torch.from_numpy(x)
    assert torch.equal(ops.sparse_layer_apply(bsr, torch_x, -0.3, device="cpu"),
                       ops.sparse_layer_apply(bsr, x, -0.3, device="cpu"))


def test_sparse_layer_apply_runs_on_the_card_by_default(monkeypatch):
    _, bsr, _ = _bsr(0, 16, 8, 0.5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ops.sparse_layer_apply(bsr, np.ones((16, 2), np.float32), 0.0)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ops.prepare_bsr_operands(bsr)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.sparse_layer_apply(bsr, np.ones((16, 2), np.float32), 0.0,
                               device="meta")


def test_bsr_spmm_fleet_fused_is_the_one_launch_fleet_op():
    assert "bsr_spmm_fleet_fused" in ops.__all__
    assert ops.bsr_spmm_fleet_fused is ops.bsr_spmm_fleet
    # the reference's signature, less its Pallas knobs (batch_block, interpret)
    names = list(inspect.signature(ops.bsr_spmm_fleet_fused).parameters)
    assert names == ["blocks", "cols", "counts", "x", "bias", "clip"]
    assert list(inspect.signature(ref_ops.bsr_spmm_fleet_fused).parameters
                )[:6] == names
    rng = np.random.default_rng(3)
    p, nbr, k, bm, bn, n_cols, b = 3, 4, 3, 8, 8, 5, 6
    blocks = rng.standard_normal((p, nbr, k, bm, bn)).astype(np.float32)
    cols = rng.integers(0, n_cols, size=(p, nbr, k)).astype(np.int32)
    counts = rng.integers(0, k + 1, size=(p, nbr)).astype(np.int32)
    x = np.abs(rng.standard_normal((p, n_cols * bn, b))).astype(np.float32)
    launches = dict(ops.LAUNCHES)
    got = ops.bsr_spmm_fleet_fused(*(torch.from_numpy(a) for a in
                                     (blocks, cols, counts, x)),
                                   bias=-0.1, clip=4.0)
    want = ref_ops.bsr_spmm_fleet_fused(*(jnp.asarray(a) for a in
                                          (blocks, cols, counts, x)),
                                        bias=-0.1, clip=4.0, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert ops.LAUNCHES == launches   # the CPU launches no kernel


def test_decode_mha_cache_size_counts_launch_plans():
    assert "decode_mha_cache_size" in decode_ops.__all__
    assert callable(ref_decode_ops.decode_mha_cache_size)
    rng = np.random.default_rng(0)
    B, H, KV, S, D = 1, 4, 2, 64, 32
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, KV, S, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, KV, S, D)).astype(np.float32))
    before = decode_ops.decode_mha_cache_size()
    for cache_len in range(1, 12):
        decode_ops.decode_mha(q, k, v, torch.tensor(cache_len, dtype=torch.int32))
    assert decode_ops.decode_mha_cache_size() == before == 0
