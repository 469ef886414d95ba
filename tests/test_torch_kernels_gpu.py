"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the BSR SpMM kernels, the split-KV decode kernel, the flash-attention
prefill kernel and the chunked SSD scan kernel.  Every test here
needs a CUDA card and skips where there is none; run them on one with
``python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.

The file imports only torch, numpy and the port (no JAX), so it runs where
the JAX package is not installed.  Tolerance 1e-5 for the BSR kernels
against the plain versions (they sum in different orders); the fleet kernel
must equal the per-worker kernel bit for bit.  The decode kernel is held to
1e-5 in fp32 and 2e-2 in bf16 (its output is rounded to bf16), and so is
the flash kernel, whose bf16 tensor-core path is also held to rtol 8e-3,
atol 1e-4 against the plain version on fp32-widened inputs; the SSD
kernel's y is held to the same, its final state to five times that, as the
reference holds the TPU kernel, and in bf16 its state also to 1e-4 and 98%
of y to the plain y rounded to bf16 (its products are exact).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.backends import (
    DenseRefAttention,
    TorchBsrBackend,
    TorchSplitKAttention,
)
from repro_torch.core.sparse import CSRMatrix, csr_from_dense, random_sparse
from repro_torch.data.graphchallenge import make_inputs, make_sparse_dnn
from repro_torch.kernels.bsr_spmm import ops, ref
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention import ref as decode_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import mamba2, moe, transformer
from repro_torch.serving.engine import ServingEngine

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


def _pattern_fleet(kind, k, bm, bn, batch, device, seed):
    """A fleet of 3 workers x 5 row blocks of signed ``kind`` weights: dense
    blocks, 4 nonzeros a block row, 1 (the GraphChallenge patterns), or
    random zeros with all-zero block rows.  Random counts, worker 2 with
    none; the slots past a row's count are zero, as the padded layout
    leaves them.  Signed x [3, 7*bn, batch]."""
    g = np.random.default_rng(seed)
    p, nbr, nbc = 3, 5, 7
    w = g.standard_normal((p, nbr, k, bm, bn))
    i, j = np.arange(bm)[:, None], np.arange(bn)[None, :]
    if kind == "four-a-row":
        keep = np.broadcast_to(j % 8 == i % 8, w.shape)
    elif kind == "one-a-row":
        keep = np.broadcast_to(j == i % bn, w.shape)
    elif kind == "random":
        keep = g.random(w.shape) < 0.3
        keep &= g.random(w.shape[:-1] + (1,)) < 0.7   # all-zero block rows
    else:
        keep = np.ones(w.shape, bool)
    counts = g.integers(0, k + 1, (p, nbr))
    counts[-1] = 0
    keep = keep & (np.arange(k)[:, None, None] < counts[..., None, None, None])
    blocks = np.where(keep, w, 0.0).astype(np.float32)
    cols = g.integers(0, nbc, (p, nbr, k)).astype(np.int32)
    x = g.standard_normal((p, nbc * bn, batch)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in
            (blocks, cols, counts.astype(np.int32), x)]


@pytest.mark.parametrize("batch", [24, 200])
@pytest.mark.parametrize("bm,bn", [(32, 32), (20, 12), (7, 5)])
@pytest.mark.parametrize("k", [1, 6])
@pytest.mark.parametrize("kind", ["dense", "four-a-row", "one-a-row",
                                  "random"])
def test_zero_skipping_kernels_on_every_block_pattern(cuda, kind, k, bm, bn,
                                                      batch):
    """Both kernels against their plain versions, and the fleet against the
    per-worker kernel bit for bit, with signed inputs, ragged blocks (bn 12
    takes 16-byte copies, bn 5 4-byte ones), K 1 (the ring's second stage
    stays empty) and K 6, and a zero-count worker."""
    blocks, cols, counts, x = _pattern_fleet(kind, k, bm, bn, batch, cuda,
                                             seed=k * 1000 + bm * 10 + batch)
    bias = 0.1 if batch == 24 else -0.3
    got = ops.bsr_spmm_fleet(blocks, cols, counts, x, bias=bias)
    torch.testing.assert_close(
        got, ref.bsr_spmm_fleet_ref(blocks, cols, counts, x, bias), **TOL)
    for p in range(x.shape[0]):
        per = ops.bsr_spmm(blocks[p], cols[p], x[p], bias=bias)
        assert torch.equal(per, got[p])
        torch.testing.assert_close(
            per, ref.bsr_spmm_fused_ref(blocks[p], cols[p], x[p], bias), **TOL)
    assert torch.equal(got[-1], torch.full_like(got[-1], max(bias, 0.0)))


@pytest.mark.parametrize("kind", ["dense", "four-a-row", "one-a-row",
                                  "random"])
def test_kernels_give_nan_where_the_plain_versions_do(cuda, kind):
    """Inf, -Inf and NaN in x's column blocks 1 and up (the padding slots
    reference column block 0, as the padded layout leaves them): both
    kernels against their plain versions, NaN in the same places and the
    rest at 1e-5, and the fleet still equal to the per-worker kernel.
    Weights and x are non-negative, as the FSI's are, so that the finite
    sums do not cancel below the tolerance's scale."""
    blocks, cols, counts, x = _pattern_fleet(kind, 6, 32, 32, 200, cuda,
                                             seed=11)
    blocks, x = blocks.abs(), x.abs()
    pad = torch.arange(blocks.shape[2], device=cuda) >= counts[..., None]
    cols = torch.where(pad, torch.zeros_like(cols), cols)
    g = np.random.default_rng(3)
    for val in (float("inf"), float("-inf"), float("nan")):
        for _ in range(4):
            x[g.integers(0, x.shape[0]), g.integers(32, x.shape[1]),
              g.integers(0, x.shape[2])] = val
    got = ops.bsr_spmm_fleet(blocks, cols, counts, x, bias=BIAS)
    want = ref.bsr_spmm_fleet_ref(blocks, cols, counts, x, BIAS)
    assert bool(want.isnan().any())
    assert torch.equal(got.isnan(), want.isnan())
    torch.testing.assert_close(got, want, equal_nan=True, **TOL)
    for p in range(x.shape[0]):
        per = ops.bsr_spmm(blocks[p], cols[p], x[p], bias=BIAS)
        assert torch.equal(per.isnan(), got[p].isnan())
        assert torch.equal(per.nan_to_num(), got[p].nan_to_num())
        want = ref.bsr_spmm_fused_ref(blocks[p], cols[p], x[p], BIAS)
        assert torch.equal(per.isnan(), want.isnan())
        torch.testing.assert_close(per, want, equal_nan=True, **TOL)


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


DECODE_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
              torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _decode_operands(device, B, H, KV, S, D, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device, dtype=dtype)
            for shape in ((B, H, D), (B, KV, S, D), (B, KV, S, D))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("G,D", [(1, 64), (2, 128), (4, 64), (8, 128), (2, 32),
                                 (1, 112), (2, 112), (8, 112)])
def test_decode_kernel_matches_plain(cuda, dtype, G, D):
    """A capacity that is no multiple of the kernel's key tile, and cache
    lengths 0 (the mean of V), 1, around the tile, and full."""
    B, KV, S = 3, 2, 200
    q, k, v = _decode_operands(cuda, B, KV * G, KV, S, D, dtype, seed=G * D)
    for L in (0, 1, 31, 32, 33, 63, 64, 65, 199, 200):
        lt = torch.tensor([L], dtype=torch.int32, device=cuda)
        n0 = decode_ops.LAUNCHES["decode_attention"]
        out, lse = decode_ops.decode_mha(q, k, v, lt)
        torch.cuda.synchronize()
        assert decode_ops.LAUNCHES["decode_attention"] == n0 + 1
        want, want_lse = decode_ref.decode_attention_ref(q, k, v, lt)
        assert out.dtype == dtype and lse.dtype == torch.float32
        torch.testing.assert_close(out.float(), want.float(), **DECODE_TOL[dtype])
        torch.testing.assert_close(lse, want_lse, **DECODE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,KV,S,D", [
    (8, 16, 8, 640, 128),     # the serving path's shape: 4 splits of 192
    (2, 16, 2, 1000, 64),     # G 8, a capacity no multiple of 64
    (4, 4, 4, 4096, 32),      # G 1, 16 splits of 4 tiles
    (64, 16, 16, 128, 64),    # B*KV 1024: one split, no merge
    (8, 32, 32, 640, 112),    # zamba2-7b's sites: D 112, padded row groups
    (2, 4, 2, 300, 112),      # D 112, G 2, fp32 tiles of 36 keys
])
def test_decode_kernel_at_split_boundaries_twice(cuda, dtype, B, H, KV, S, D):
    """cache_len 0 and one key either side of every split's first and last
    key, each launched twice: the second launch agrees bit for bit, so the
    first left its tickets at zero."""
    q, k, v = _decode_operands(cuda, B, H, KV, S, D, dtype, seed=S + D)
    n_split, split_keys = decode_ops.plan_for(q, k)
    edges = {0, 1, S - 1, S}
    for j in range(n_split):
        for e in (j * split_keys, min((j + 1) * split_keys, S) - 1):
            edges.update((e - 1, e, e + 1))
    for L in sorted(x for x in edges if 0 <= x <= S):
        lt = torch.tensor([L], dtype=torch.int32, device=cuda)
        first = decode_ops.decode_mha(q, k, v, lt)
        second = decode_ops.decode_mha(q, k, v, lt)
        torch.cuda.synchronize()
        want, want_lse = decode_ref.decode_attention_ref(q, k, v, lt)
        torch.testing.assert_close(first[0].float(), want.float(),
                                   **DECODE_TOL[dtype])
        torch.testing.assert_close(first[1], want_lse, **DECODE_TOL[dtype])
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_decode_kernel_d112_takes_one_length_per_row(cuda, dtype):
    """D 112 with ``[B]`` lengths (0, a split's edge, the capacity): each
    row bit for bit its own launch, and within tolerance of the plain
    version."""
    B, H, KV, S, D = 4, 4, 4, 640, 112
    q, k, v = _decode_operands(cuda, B, H, KV, S, D, dtype, seed=112)
    lens = torch.tensor([0, 191, 192, 640], dtype=torch.int32, device=cuda)
    out, lse = decode_ops.decode_mha(q, k, v, lens)
    want, want_lse = decode_ref.decode_attention_ref(q, k, v, lens)
    torch.testing.assert_close(out.float(), want.float(), **DECODE_TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **DECODE_TOL[dtype])
    for b in range(B):
        row = decode_ops.decode_mha(q, k, v, lens[b:b + 1].contiguous())
        assert torch.equal(out[b], row[0][b]) and torch.equal(lse[b], row[1][b])


def test_splitk_backend_on_the_card_matches_the_cpu_oracle(cuda):
    q, k, v = _decode_operands(cuda, 2, 16, 8, 128, 128, torch.float32, seed=3)
    got = TorchSplitKAttention(device="cuda").decode(q[:, None], k, v, 77)
    want = DenseRefAttention().decode(q[:, None].cpu(), k.cpu(), v.cpu(), 77)
    torch.testing.assert_close(got.cpu(), want, **DECODE_TOL[torch.float32])


def test_decode_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _decode_operands(cuda, 1, 6, 2, 16, 64, torch.float32, seed=0)
    with pytest.raises(ValueError, match="G = H/KV"):  # G = 3
        decode_ops.decode_mha(q, k, v, 4)
    q, k, v = _decode_operands(cuda, 1, 4, 2, 16, 48, torch.float32, seed=0)
    with pytest.raises(ValueError, match="D in"):
        decode_ops.decode_mha(q, k, v, 4)
    q, k, v = _decode_operands(cuda, 1, 4, 2, 16, 64, torch.float32, seed=0)
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode_ops.decode_mha(shifted, k, v, 4)
    with pytest.raises(ValueError, match="cache_len is on"):
        decode_ops.decode_mha(q, k, v, torch.tensor([4], dtype=torch.int32))


def test_engine_on_the_card_generates_the_cpu_tokens(cuda):
    """The reduced internlm2 (D 32, G 2) in fp32: the engine on the card,
    through the kernel, and on the CPU, through its plain version, pick the
    same greedy tokens."""
    cfg = get_config("internlm2-1.8b").reduced()
    gen = torch.Generator(device=cuda).manual_seed(0)
    on_card = transformer.init(gen, cfg, dtype=torch.float32)
    on_cpu = transformer.Transformer(cfg, dtype=torch.float32, device="cpu")
    for dst, src in zip(on_cpu.parameters(), on_card.parameters()):
        dst.copy_(src.cpu())
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9))
    n0 = decode_ops.LAUNCHES["decode_attention"]
    got = ServingEngine(cfg, params=on_card).generate(prompts, max_new_tokens=5)
    assert decode_ops.LAUNCHES["decode_attention"] == n0 + cfg.n_layers * 5
    want = ServingEngine(cfg, params=on_cpu, device="cpu").generate(
        prompts, max_new_tokens=5)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.prefill_logits, want.prefill_logits,
                               rtol=1e-4, atol=1e-4)


# reduced zamba2-7b (3 sites, a tail), seamless-m4t-medium (self and cross
# attention) and internvl2-2b (8 image embeddings): decode launches a step
NEW_FAMILIES = {"zamba2-7b": lambda c: -(-c.n_layers // c.shared_attn_every),
                "seamless-m4t-medium": lambda c: 2 * c.n_layers,
                "internvl2-2b": lambda c: c.n_layers}


@pytest.mark.parametrize("arch", sorted(NEW_FAMILIES))
def test_new_families_on_the_card_generate_the_cpu_tokens(cuda, arch):
    """The hybrid, encdec and vlm families, reduced, in fp32: the engine on
    the card through the kernel and on the CPU through its plain version
    pick the same greedy tokens (logits 1e-4), with their frontend inputs;
    the card launches the kernel at every site (or layer, twice for the
    encoder-decoder) of every step."""
    from repro_torch.models.registry import get_model

    cfg = get_config(arch).reduced()
    gen = torch.Generator(device=cuda).manual_seed(0)
    on_card = get_model(cfg, attn_backend="dense-ref").init(gen)
    on_card = on_card.float()
    on_cpu = type(on_card)(cfg, dtype=torch.float32, device="cpu")
    for dst, src in zip(on_cpu.parameters(), on_card.parameters()):
        dst.copy_(src.cpu())
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (2, 9))
    key = {"vlm": "extra_embeds", "encdec": "frames"}.get(cfg.family)
    extra = ({key: rng.standard_normal((2, cfg.frontend_tokens, cfg.d_model))
              .astype(np.float32)} if key else None)
    n0 = decode_ops.LAUNCHES["decode_attention"]
    got = ServingEngine(cfg, params=on_card).generate(prompts, max_new_tokens=5,
                                                      extra=extra)
    assert decode_ops.LAUNCHES["decode_attention"] == \
        n0 + NEW_FAMILIES[arch](cfg) * 5
    want = ServingEngine(cfg, params=on_cpu, device="cpu").generate(
        prompts, max_new_tokens=5, extra=extra)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.prefill_logits, want.prefill_logits,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,D,causal", [
    (2, 4, 4, 128, 128, 64, True),     # MHA
    (1, 8, 2, 200, 200, 128, True),    # GQA, a ragged last tile
    (2, 6, 3, 96, 160, 64, False),     # non-causal, Sq != Sk
    (1, 4, 1, 160, 96, 128, True),     # causal, Sq > Sk (top-left aligned)
    (3, 16, 8, 64, 64, 128, True),     # one tile
])
def test_flash_kernel_matches_plain(cuda, dtype, B, H, KV, Sq, Sk, D, causal):
    gen = torch.Generator(device=cuda).manual_seed(Sq + Sk + D)
    q, k, v = [torch.randn(shape, generator=gen, device=cuda, dtype=dtype)
               for shape in ((B, H, Sq, D), (B, KV, Sk, D), (B, KV, Sk, D))]
    n0 = flash_ops.LAUNCHES["flash_attention"]
    got = flash_ops.mha(q, k, v, causal=causal, block_q=8, block_k=8)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES["flash_attention"] == n0 + 1
    want = flash_ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **DECODE_TOL[dtype])


# a bf16 output of a kernel that computes in fp32 and rounds once, against
# the plain version on fp32-widened inputs (as chip_smoke.py holds it)
ULP_TOL = dict(rtol=8e-3, atol=1e-4)
# and the share of its elements equal to that version rounded to bf16: an
# fp32 p·v misses it only by summation order, a p rounded to bf16 (as the
# plain version in bf16 rounds it) in about 42% of the elements
EXACT_SHARE = 0.98


@pytest.mark.parametrize("B,H,KV,Sq,Sk,D,causal", [
    (1, 2, 2, 100, 100, 64, True),     # G 1, ragged: less than one tile
    (2, 4, 2, 192, 192, 128, True),    # G 2, one and a half query tiles
    (1, 8, 1, 100, 100, 128, True),    # G 8
    (1, 4, 2, 96, 160, 64, False),     # non-causal, Sq != Sk
    (1, 8, 1, 160, 96, 128, True),     # causal, Sq > Sk (top-left aligned)
    (1, 4, 4, 300, 200, 64, False),    # both ragged, non-causal
    (2, 16, 8, 64, 64, 128, True),     # one tile
])
def test_flash_tensor_core_kernel_matches_plain(cuda, B, H, KV, Sq, Sk, D,
                                               causal):
    """bf16 inputs run the wgmma kernel: against the plain version in bf16,
    and against the plain version on fp32-widened inputs to one rounding
    of the output, nearly every element equal to its bf16 rounding (p·v in
    three exact bf16 pieces is the fp32 p·v)."""
    gen = torch.Generator(device=cuda).manual_seed(Sq * 7 + Sk + D)
    q, k, v = [torch.randn(shape, generator=gen, device=cuda,
                           dtype=torch.bfloat16)
               for shape in ((B, H, Sq, D), (B, KV, Sk, D), (B, KV, Sk, D))]
    n0 = flash_ops.LAUNCHES["flash_attention"]
    got = flash_ops.mha(q, k, v, causal=causal, block_q=Sq, block_k=Sk)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES["flash_attention"] == n0 + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = flash_ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(),
                               **DECODE_TOL[torch.bfloat16])
    wide = flash_ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                         causal=causal)
    torch.testing.assert_close(got.float(), wide, **ULP_TOL)
    share = (got == wide.bfloat16()).float().mean().item()
    assert share >= EXACT_SHARE, share


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = [torch.randn((1, 4, 64, 48), generator=gen, device=cuda)
               for _ in range(3)]
    with pytest.raises(ValueError, match="D in"):
        flash_ops.mha(q, k, v)
    q = torch.randn((1, 4, 64, 64), generator=gen, device=cuda)
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_ops.mha(shifted, q, q)
    with pytest.raises(ValueError, match="is on"):
        flash_ops.mha(q, q.cpu(), q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,G,L,P,N,chunk", [
    (2, 4, 1, 192, 32, 16, 64),
    (1, 4, 2, 256, 64, 32, 128),
    (2, 6, 3, 96, 32, 64, 48),       # a chunk that is no multiple of 64
    (1, 2, 1, 64, 16, 8, 32),
    (2, 4, 2, 512, 64, 128, 256),    # mamba2-370m's widths
    (1, 2, 1, 4096, 64, 128, 256),   # 16 chunks, two (b, h) pairs
    (1, 8, 2, 1024, 64, 128, 256),   # 4 heads a group
    (1, 4, 2, 400, 64, 128, 80),     # 5 chunks of 80
    (1, 2, 1, 512, 16, 8, 16),       # 32 chunks of one scan block
])
def test_ssd_kernel_matches_plain(cuda, dtype, B, H, G, L, P, N, chunk):
    gen = torch.Generator(device=cuda).manual_seed(L + P + N)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    x, Bm, Cm = rn(B, H, L, P).to(dtype), rn(B, G, L, N).to(dtype), rn(B, G, L, N).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, H, L))
    A = -torch.exp(rn(H) * 0.3)
    n0 = ssd_ops.LAUNCHES["ssd_scan"]
    y, s = ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES["ssd_scan"] == n0 + 1
    want_y, want_s = ssd_ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    tol = DECODE_TOL[dtype]
    assert y.dtype == dtype and s.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y, **tol)
    torch.testing.assert_close(s, want_s, rtol=5 * tol["rtol"],
                               atol=5 * tol["atol"])
    if dtype == torch.bfloat16:  # one rounding of an fp32 result
        wide = ssd_ref.ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float(),
                                    chunk=chunk)[0]
        torch.testing.assert_close(y.float(), wide, rtol=8e-3, atol=1e-4)
        # exact products (C·B of bf16, each fp32 operand in three bf16
        # pieces): the state within 1e-4 of the plain version, which widens
        # to fp32, and >= 98% of y equal to its y rounded (one piece in place
        # of three misses both)
        torch.testing.assert_close(s, want_s, rtol=1e-4, atol=1e-4)
        share = (y == wide.bfloat16()).float().mean().item()
        assert share >= 0.98, share


def test_ssd_phases_launch_at_least_132_blocks_at_the_long_shape(cuda):
    """B 1, H 32, L 16384, chunk 256 (mamba2-370m's widths): each of the
    four launches of one call, as the profiler's trace records its grid,
    has at least 132 blocks (the SMs of an H100)."""
    import json
    import math
    import tempfile
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda).manual_seed(1)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    B, H, G, L, P, N, chunk = 1, 32, 1, 16384, 64, 128, 256
    x, Bm, Cm = (rn(*sh).bfloat16() for sh in ((B, H, L, P), (B, G, L, N),
                                                (B, G, L, N)))
    dt = torch.nn.functional.softplus(rn(B, H, L) - 4.0)
    A = -torch.ones(H, device=cuda)
    ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=chunk)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    blocks = {}
    for e in events:
        for name in ssd_ops.PHASES:
            if e.get("cat") == "kernel" and name in e.get("name", ""):
                blocks[name] = math.prod(e["args"]["grid"])
    assert set(blocks) == set(ssd_ops.PHASES), blocks
    assert min(blocks.values()) >= 132, blocks


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_ssd_kernel_final_state_matches_the_sequential_recurrence(cuda, chunk):
    """The state passed over 16, 8 and 4 chunks against the per-token
    recurrence S = exp(dt A) S + dt x ⊗ B, at 1e-4 (the reference's)."""
    gen = torch.Generator(device=cuda).manual_seed(chunk)
    B, H, L, P, N = 1, 2, 256, 16, 8

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    x, Bm, Cm = rn(B, H, L, P), rn(B, 1, L, N), rn(B, 1, L, N)
    dt = torch.nn.functional.softplus(rn(B, H, L) - 2.0)
    A = -torch.exp(rn(H) * 0.3)
    _, s = ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=chunk)
    want = torch.zeros_like(s)
    for t in range(L):
        a = torch.exp(dt[:, :, t] * A[None])
        want = want * a[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, :, t], Bm[:, 0, t], x[:, :, t])
    torch.testing.assert_close(s, want, rtol=1e-4, atol=1e-4)


def test_ssd_kernel_takes_views_that_start_off_16_bytes(cuda):
    """The kernels load 16 bytes at a time; the wrapper copies an operand
    whose data starts elsewhere (a view at an offset) and gives the same
    result."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    B, H, G, L, P, N, chunk = 1, 2, 1, 128, 32, 16, 64

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    x, Bm, Cm = (rn(*sh).bfloat16() for sh in ((B, H, L, P), (B, G, L, N),
                                                (B, G, L, N)))
    dt = torch.nn.functional.softplus(rn(B, H, L))
    A = -torch.exp(rn(H) * 0.3)
    shifted = []
    for t in (x, Bm, Cm):
        v = torch.empty(t.numel() + 2, dtype=t.dtype, device=cuda)[2:].view(t.shape)
        v.copy_(t)
        assert v.is_contiguous() and v.data_ptr() % 16 != 0
        shifted.append(v)
    y, s = ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=chunk)
    ys, ss = ssd_ops.ssd(shifted[0], dt, A, shifted[1], shifted[2], chunk=chunk)
    assert torch.equal(ys, y) and torch.equal(ss, s)


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((1, 2, 64, 24), device=cuda)
    dt, A = torch.ones((1, 2, 64), device=cuda), -torch.ones(2, device=cuda)
    Bm = torch.zeros((1, 1, 64, 16), device=cuda)
    with pytest.raises(ValueError, match=r"\(P, N\) in"):
        ssd_ops.ssd(x, dt, A, Bm, Bm, chunk=32)
    x = torch.zeros((1, 2, 512, 32), device=cuda)
    dt = torch.ones((1, 2, 512), device=cuda)
    Bm = torch.zeros((1, 1, 512, 16), device=cuda)
    with pytest.raises(ValueError, match="chunk <="):
        ssd_ops.ssd(x, dt, A, Bm, Bm, chunk=512)


def test_mamba2_engine_on_the_card_generates_the_cpu_tokens(cuda):
    """The reduced mamba2-370m in fp32: the engine on the card and on the
    CPU pick the same greedy tokens; the path launches no hand-written
    kernel."""
    cfg = get_config("mamba2-370m").reduced()
    gen = torch.Generator(device=cuda).manual_seed(0)
    on_card = mamba2.init(gen, cfg, dtype=torch.float32)
    on_cpu = mamba2.Mamba2(cfg, dtype=torch.float32, device="cpu")
    for dst, src in zip(on_cpu.parameters(), on_card.parameters()):
        dst.copy_(src.cpu())
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    n0 = (dict(ssd_ops.LAUNCHES), dict(decode_ops.LAUNCHES))
    got = ServingEngine(cfg, params=on_card).generate(prompts, max_new_tokens=5)
    assert (ssd_ops.LAUNCHES, decode_ops.LAUNCHES) == n0
    want = ServingEngine(cfg, params=on_cpu, device="cpu").generate(
        prompts, max_new_tokens=5)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.prefill_logits, want.prefill_logits,
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# continuous batching: one cache length per row, the graphed step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,KV,S,D", [
    (8, 16, 8, 640, 128),     # the serving path's shape
    (5, 8, 2, 200, 64),       # G 4, a capacity no multiple of 64
])
def test_decode_kernel_takes_one_length_per_row(cuda, dtype, B, H, KV, S, D):
    """Mixed per-row lengths (0, 1, around a tile, full, past the capacity)
    against the plain version, and each row bit for bit the launch of its
    own length as the batch's one length."""
    q, k, v = _decode_operands(cuda, B, H, KV, S, D, dtype, seed=B + S)
    base = [0, 1, 63, 64, 65, S - 1, S, S + 7]
    lens = torch.tensor((base * 2)[:B], dtype=torch.int32, device=cuda)
    n0 = decode_ops.LAUNCHES["decode_attention"]
    out, lse = decode_ops.decode_mha(q, k, v, lens)
    assert decode_ops.LAUNCHES["decode_attention"] == n0 + 1
    want, want_lse = decode_ref.decode_attention_ref(q, k, v, lens)
    torch.testing.assert_close(out.float(), want.float(), **DECODE_TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **DECODE_TOL[dtype])
    for b in range(B):
        one, one_lse = decode_ops.decode_mha(q, k, v, lens[b:b + 1])
        assert torch.equal(out[b], one[b]) and torch.equal(lse[b], one_lse[b]), b


def _cb_stream(cfg, seed, n=7):
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(2, 12))),
                    max_new_tokens=int(rng.integers(1, 7)),
                    arrival=int(rng.integers(0, 5))) for i in range(n)]


_FAMILY_MODULES = {"dense": (transformer, "Transformer"),
                   "moe": (moe, "Moe"), "ssm": (mamba2, "Mamba2")}


def _cb_params(cuda, arch):
    cfg = get_config(arch).reduced()
    gen = torch.Generator(device=cuda).manual_seed(0)
    mod = _FAMILY_MODULES[cfg.family][0]
    return cfg, mod, mod.init(gen, cfg, dtype=torch.float32)


def _on_cpu(cfg, params):
    """A CPU copy of card params, leaf by leaf."""
    mod, cls = _FAMILY_MODULES[cfg.family]
    out = getattr(mod, cls)(cfg, dtype=torch.float32, device="cpu")
    for dst, src in zip(out.parameters(), params.parameters()):
        dst.copy_(src.cpu())
    return out


def _kernel_events(fn, name: str) -> int:
    """Launches of device kernels whose name holds ``name`` while ``fn``
    runs, counted in ``torch.profiler``'s trace (a replayed CUDA graph's
    kernels appear there one by one)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and name in e.key)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-moe-16b",
                                  "mamba2-370m"])
def test_graph_replay_equals_the_eager_step_and_captures_once(cuda, arch):
    """One stream churning through 3 slots, graphed and eager: the same
    tokens and final logits bit for bit; the graph is captured once over
    two streams, the decode kernel runs n_layers times a replayed step in
    the profiler's trace (replays do not pass through the wrapper, whose
    count stands still), and every page comes back."""
    from repro_torch.serving.scheduler import RequestScheduler

    cfg, _, params = _cb_params(cuda, arch)
    eng = ServingEngine(cfg, params=params)
    reqs = _cb_stream(cfg, 3)
    layout = eng.cache_layout(24)
    cap = layout.padded_len(24)
    graphed = RequestScheduler(eng.model, params, 3, cap, layout=layout)
    assert graphed.graph and graphed.captures == 1
    eager = RequestScheduler(eng.model, params, 3, cap, layout=layout,
                             graph=False)
    n0 = decode_ops.LAUNCHES["decode_attention"]
    out = []
    seen = _kernel_events(lambda: out.extend(graphed.run(reqs)),
                          "decode_attention_kernel")
    got = {r.rid: r for r in out}
    per_step = 0 if cfg.family == "ssm" else cfg.n_layers
    assert seen == per_step * graphed.steps_run
    assert decode_ops.LAUNCHES["decode_attention"] == n0
    again = {r.rid: r for r in graphed.run(reqs)}
    want = {r.rid: r for r in eager.run(reqs)}
    assert graphed.captures == 1 and eager.captures == 0
    assert graphed.pool.allocator.live_blocks == 0
    for rid, w in want.items():
        for g in (got[rid], again[rid]):
            np.testing.assert_array_equal(g.tokens, w.tokens)
            assert np.array_equal(g.final_logits, w.final_logits), rid


def test_graph_keeps_its_scratch_when_stream_handles_recur(cuda):
    """The graph owns the decode wrapper's scratch it was captured with:
    after decodes at a larger B·KV·n_split on more streams than torch's
    pool has handles (so the capture stream's handle recurs, and scratch
    kept per handle grows and is freed), and the freed memory is
    overwritten, a replayed stream still equals the eager one bit for
    bit."""
    from repro_torch.serving.scheduler import RequestScheduler

    cfg, _, params = _cb_params(cuda, "internlm2-1.8b")
    eng = ServingEngine(cfg, params=params)
    reqs = _cb_stream(cfg, 7)
    layout = eng.cache_layout(200)   # several tiles: the kernel splits
    cap = layout.padded_len(200)
    graphed = RequestScheduler(eng.model, params, 3, cap, layout=layout)
    assert graphed._graph_scratch is not None
    q, k, v = _decode_operands(cuda, 16, 16, 8, 4096, 128, torch.float32, 1)
    for _ in range(80):
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            decode_ops.decode_mha(q, k, v, 4096)
        side.synchronize()
    decode_ops._scratch.clear()
    torch.cuda.empty_cache()
    junk = torch.full((1 << 26,), 7, dtype=torch.int32, device=cuda)
    got = {r.rid: r for r in graphed.run(reqs)}
    del junk
    eager = RequestScheduler(eng.model, params, 3, cap, layout=layout,
                             graph=False)
    for w in eager.run(reqs):
        np.testing.assert_array_equal(got[w.rid].tokens, w.tokens)
        assert np.array_equal(got[w.rid].final_logits, w.final_logits), w.rid


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-moe-16b",
                                  "mamba2-370m"])
def test_engine_stream_on_the_card_gives_the_cpu_tokens(cuda, arch):
    """``generate_stream`` on the card (graphed, through the kernel) and on
    the CPU (eager, through its plain version), fp32: the same tokens,
    final logits within 1e-4."""
    cfg, mod, params = _cb_params(cuda, arch)
    on_cpu = _on_cpu(cfg, params)
    reqs = _cb_stream(cfg, 5)
    got = {r.rid: r for r in ServingEngine(cfg, params=params).generate_stream(
        reqs, num_slots=3)}
    want = ServingEngine(cfg, params=on_cpu, device="cpu").generate_stream(
        reqs, num_slots=3)
    for w in want:
        np.testing.assert_array_equal(got[w.rid].tokens, w.tokens)
        np.testing.assert_allclose(got[w.rid].final_logits, w.final_logits,
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the moe family and the LM pipeline on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("groups", [1, 24])
def test_moe_ffn_gives_the_same_bits_twice(cuda, dtype, groups):
    """The combine adds in a fixed order with no atomics: two runs of
    ``moe_ffn`` (with drops at one group, one group a row at 24) give the
    same bits, and agree with the CPU's run within 1e-5 in fp32."""
    cfg = get_config("deepseek-moe-16b").reduced()
    gen = torch.Generator(device=cuda).manual_seed(2)
    params = moe.init(gen, cfg, dtype=dtype)
    blk = params.moe_blocks[0].moe
    x = torch.randn((24, 1, cfg.d_model), generator=gen, device=cuda).to(dtype)
    a, ma = moe.moe_ffn(blk, x, cfg, dp_groups=groups)
    b, _ = moe.moe_ffn(blk, x, cfg, dp_groups=groups)
    assert torch.equal(a, b)
    if dtype == torch.float32:
        cpu = _on_cpu(cfg, params).moe_blocks[0].moe
        want, mw = moe.moe_ffn(cpu, x.cpu(), cfg, dp_groups=groups)
        np.testing.assert_allclose(a.cpu().numpy(), want.numpy(), **TOL)
        assert float(ma["drop_frac"]) == pytest.approx(float(mw["drop_frac"]))


def test_bf16_q_over_an_fp32_cache_launches_the_fp32_kernel(cuda):
    """The moe decode's shape (G 1, D 128): a bf16 ``q`` over the fp32
    cache is widened, the fp32 kernel runs once, and the output is that of
    the all-fp32 call rounded to bf16, bit for bit."""
    q, k, v = _decode_operands(cuda, 8, 16, 16, 640, 128, torch.float32, 3)
    qb = q.to(torch.bfloat16)[:, None]
    lens = torch.tensor([0, 1, 513, 544, 640, 64, 65, 300], dtype=torch.int32,
                        device=cuda)
    be = TorchSplitKAttention()
    n0 = decode_ops.LAUNCHES["decode_attention"]
    got = be.decode(qb, k, v, lens)
    assert decode_ops.LAUNCHES["decode_attention"] == n0 + 1
    want = be.decode(qb.float(), k, v, lens)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_reduced_pipeline_on_the_card_gives_the_cpu_tokens(cuda):
    """deepseek-moe-16b reduced, fp32, P 2 on the queue: the pipeline on the
    card equals the card's device engine bit for bit, and picks the CPU
    pipeline's tokens (logits within 1e-4) with the same billed counts."""
    from repro_torch.faas.lm_pipeline import run_lm_pipeline

    cfg, _, params = _cb_params(cuda, "deepseek-moe-16b")
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 9))
    n0 = decode_ops.LAUNCHES["decode_attention"]
    got = run_lm_pipeline(cfg, prompts, params, max_new_tokens=4, P=2)
    assert decode_ops.LAUNCHES["decode_attention"] == n0 + cfg.n_layers * 4
    engine = ServingEngine(cfg, params=params).generate(prompts, 4)
    np.testing.assert_array_equal(got.tokens, engine.tokens)
    assert np.array_equal(got.logits, engine.prefill_logits)
    want = run_lm_pipeline(cfg, prompts, _on_cpu(cfg, params),
                           max_new_tokens=4, P=2)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logits, want.logits, rtol=1e-4, atol=1e-4)
    assert got.stats.publish_units == want.stats.publish_units
    assert got.raw_exchange_bytes == want.raw_exchange_bytes
