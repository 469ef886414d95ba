"""The decode kernel's paged form and the scheduler's step over the KV
pool's pages.  On the CPU (no JAX): the plain paged version against the
contiguous one over shuffled block tables, a scheduler whose pages are
handed out in a permuted order against one with ordered pages, and
``gather_steps`` on the paged and the gathering paths.  On a card
(``gpu``): the paged kernel against the contiguous kernel over the gathered
copy, bit for bit, and the wrapper's refusals."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.backends import TorchSplitKAttention
from repro_torch.kernels.decode_attention import ops, ref
from repro_torch.launch.mesh import make_mesh
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import Request, RequestScheduler

PAGE = 256                      # the served cells' block_k
ARCHS = {"dense": "internlm2-1.8b", "vlm": "internvl2-2b",
         "moe": "deepseek-moe-16b", "ssm": "mamba2-370m"}


def _paged(device, B, H, KV, W, bk, D, dtype, seed, layers=2):
    """q, K and V pages as layer 1 of a ``[num_blocks, layers, KV, bk, D]``
    buffer (a page stride larger than a page, as the pool's), and a table
    of distinct page ids drawn in shuffled order."""
    gen = torch.Generator().manual_seed(seed)
    nb = B * W + 3
    q, k, v = (torch.randn(shape, generator=gen).to(device, dtype)
               for shape in ((B, H, D), (nb, layers, KV, bk, D),
                             (nb, layers, KV, bk, D)))
    table = torch.randperm(nb, generator=gen)[:B * W].view(B, W)
    return q, k[:, 1], v[:, 1], table.to(device, torch.int32)


def _by_hand(pages, table):
    """The contiguous cache ``[B, KV, W * bk, D]``, page by page."""
    return torch.stack([torch.cat([pages[int(p)] for p in row], dim=1)
                        for row in table.cpu()])


@pytest.mark.parametrize("lengths", [(0,), (1,), (PAGE - 1,), (PAGE,),
                                     (PAGE + 1,), (3 * PAGE,),
                                     (0, PAGE + 1, 3 * PAGE)])
def test_plain_paged_form_is_the_contiguous_form(lengths):
    q, k, v, table = _paged("cpu", 3, 8, 2, 3, PAGE, 16, torch.float32,
                            seed=len(lengths) * 1000 + lengths[-1])
    lens = torch.tensor(lengths, dtype=torch.int32)
    kc, vc = _by_hand(k, table), _by_hand(v, table)
    assert torch.equal(ref.gather_pages(k, table), kc)
    out, lse = ops.decode_mha_paged(q, k, v, table, lens)
    want, want_lse = ops.decode_mha(q, kc, vc, lens)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)


def _engine(fam):
    return ServingEngine(get_config(ARCHS[fam]).reduced(), device="cpu",
                         attn_backend=TorchSplitKAttention(block_k=4,
                                                           device="cpu"))


def _requests(cfg, n=5, seed=0):
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(
        rng.integers(2, 9))).astype(np.int32),
        max_new_tokens=int(rng.integers(2, 7)), arrival=int(rng.integers(0, 3)))
        for i in range(n)]
    if cfg.frontend_tokens:
        for r in reqs:
            r.extra = {"extra_embeds": rng.standard_normal(
                (1, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)}
    return reqs


def _scheduler(eng, **kw):
    layout = eng.cache_layout(16 + (eng.cfg.frontend_tokens or 0))
    return RequestScheduler(eng.model, eng.params, 2,
                            layout.padded_len(16 + (eng.cfg.frontend_tokens or 0)),
                            layout=layout, device="cpu", **kw)


def test_permuted_pages_serve_the_same_bits_as_ordered_pages():
    eng = _engine("dense")
    reqs = _requests(eng.cfg)
    ordered = _scheduler(eng)
    shuffled = _scheduler(eng)
    free = shuffled.pool.allocator._free
    free[:] = list(np.random.default_rng(1).permutation(free))
    want = {r.rid: r for r in ordered.run(reqs)}
    got = {r.rid: r for r in shuffled.run(reqs)}
    assert not np.array_equal(ordered._tables, shuffled._tables)
    assert sorted(got) == sorted(want)
    for rid in want:
        assert np.array_equal(got[rid].tokens, want[rid].tokens)
        assert np.array_equal(got[rid].final_logits, want[rid].final_logits)


@pytest.mark.parametrize("case", ["dense", "vlm", "moe", "ssm", "dense-mesh",
                                  "dense-dense-ref"])
def test_gather_steps_count_the_steps_that_gathered(case):
    fam = case.split("-")[0]
    if case.endswith("dense-ref"):  # a backend without a paged form
        eng = ServingEngine(get_config(ARCHS[fam]).reduced(), device="cpu",
                            attn_backend="dense-ref")
    else:
        eng = _engine(fam)
    kw = {"mesh": make_mesh((2,), ("seq",), ["cpu"] * 2)} if "mesh" in case else {}
    sched = _scheduler(eng, **kw)
    reqs = _requests(eng.cfg, n=3, seed=2)
    got = sched.run(reqs)
    assert len(got) == len(reqs) and sched.steps_run > 0
    # one device never gathers the pool, whatever the backend (dense-ref
    # attends over each layer's pages gathered by the table); the mesh does
    gathers = sched.steps_run if case.endswith("mesh") else 0
    assert sched.gather_steps == gathers


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 2, 5, 128), (16, 8, 10, 64)],
                         ids=["splits-in-a-page", "pages-in-a-split"])
@pytest.mark.parametrize("D", [64, 112, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_paged_kernel_is_the_contiguous_kernel_bit_for_bit(cuda, dtype, G, D,
                                                          shape):
    """Over shuffled pages of a layer's strided slice: every length at a
    page's and a split's edges +-1, 0 and the capacity, and one length a
    row, each bit for bit the contiguous kernel over the gathered copy."""
    B, KV, W, bk = shape
    q, k, v, table = _paged(cuda, B, KV * G, KV, W, bk, D, dtype,
                            seed=G * D + bk)
    kc, vc = ref.gather_pages(k, table), ref.gather_pages(v, table)
    S = W * bk
    n_split, split_keys = ops.plan_for(q, kc)
    assert ops.plan_for(q, k, S) == (n_split, split_keys)
    edges = {0, S}
    for step in (bk, split_keys):
        for e in range(step, S, step):
            edges.update((e - 1, e, e + 1))
    lens = [torch.tensor([L], dtype=torch.int32, device=cuda)
            for L in sorted(edges)]
    lens.append(torch.tensor([(7 * b * S) // 11 % S + 1 for b in range(B)],
                             dtype=torch.int32, device=cuda))
    for lt in lens:
        n0 = ops.LAUNCHES["decode_attention_paged"]
        out, lse = ops.decode_mha_paged(q, k, v, table, lt)
        want, want_lse = ops.decode_mha(q, kc, vc, lt)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["decode_attention_paged"] == n0 + 1
        assert torch.equal(out, want), f"out differs at lengths {lt.tolist()}"
        assert torch.equal(lse, want_lse), f"lse differs at {lt.tolist()}"


@pytest.mark.gpu
def test_paged_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v, table = _paged(cuda, 2, 4, 2, 3, 16, 128, torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match="cross a page"):
        ops.decode_mha_paged(q, k, v, table, 5)
    q, k, v, table = _paged(cuda, 2, 4, 2, 3, 64, 128, torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match="table is on"):
        ops.decode_mha_paged(q, k, v, table.cpu(), 5)
    with pytest.raises(TypeError, match="int32"):
        ops.decode_mha_paged(q, k, v, table.long(), 5)
    with pytest.raises(ValueError, match="G = H/KV"):
        ops.decode_mha_paged(q[:, :3].contiguous(), k[:, :1], v[:, :1], table, 5)
