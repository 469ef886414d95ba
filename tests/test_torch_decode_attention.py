"""The port's split-KV decode op (``repro_torch.kernels.decode_attention``)
against the JAX package's Pallas kernel, on the same inputs made with numpy.

On the CPU the port's ``decode_mha`` runs its plain PyTorch version; the
reference runs its Pallas kernel in interpret mode with ``block_k=8`` (so
the sweep crosses real block edges) and its own oracle
(``decode_attention_ref``).  Tolerances are the reference's
(``tests/test_attention_backends.py``): 1e-5 in fp32, where the two sides
only sum in different orders, and 2e-2 in bf16, where the output is
rounded to bf16 and the reference's oracle rounds the probabilities to
bf16 before ``p @ v``.  ``cache_len = 0`` is swept too: every position is
masked, and both sides give the mean of V over the whole capacity.
The kernel splits each cache across blocks and merges their partials by
lse; two tests hold the split plan's coverage and the merge's algebra.
``tests/test_torch_kernels_gpu.py`` holds the CUDA kernel against the plain
version on the card.
"""

import math

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.backends import PallasSplitKAttention  # noqa: E402
from repro.kernels.decode_attention import ops as ref_ops  # noqa: E402
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as jax_decode_attention_ref,
)
from repro_torch.core.backends import TorchSplitKAttention  # noqa: E402
from repro_torch.kernels.decode_attention import ops, ref  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    combine_split_kv_stacked,
    decode_attention,
    decode_attention_dense,
)

BLOCK_K = 8
B, KV, S = 2, 2, 24
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# cache_len traced, so each shape compiles once for the whole sweep
_jax_oracle = jax.jit(jax_decode_attention_ref)


def _edge_cache_lens(cap: int, block_k: int = BLOCK_K):
    """0, 1, the block_k boundary, cap − 1 and the full cache."""
    lens = {0, 1, block_k - 1, block_k, block_k + 1, cap - 1, cap}
    return sorted(l for l in lens if 0 <= l <= cap)


def _inputs(G, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, KV * G, D)).astype(np.float32),
            rng.standard_normal((B, KV, S, D)).astype(np.float32),
            rng.standard_normal((B, KV, S, D)).astype(np.float32))


def _as_torch(arrays, dt):
    return [torch.from_numpy(a).to(TORCH_DT[dt]) for a in arrays]


def _as_jax(arrays, dt):
    return [jnp.asarray(a, JAX_DT[dt]) for a in arrays]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 64, 112])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_mha_matches_pallas_kernel_and_oracle(G, D, dt):
    arrays = _inputs(G, D, seed=10 * G + D)
    q, k, v = _as_torch(arrays, dt)
    jq, jk, jv = _as_jax(arrays, dt)
    for cache_len in _edge_cache_lens(S):
        out, lse = ops.decode_mha(q, k, v, cache_len)
        assert out.shape == (B, KV * G, D) and out.dtype == TORCH_DT[dt]
        assert lse.shape == (B, KV * G) and lse.dtype == torch.float32
        want, want_lse = ref_ops.decode_mha(
            jq, jk, jv, jnp.asarray(cache_len, jnp.int32), block_k=BLOCK_K,
            interpret=True)
        msg = f"G={G} D={D} {dt} cache_len={cache_len}"
        np.testing.assert_allclose(_np(out), _np(want), err_msg=msg, **TOL[dt])
        if cache_len:  # at 0 the lse is -1e30 + log(S) on both sides
            np.testing.assert_allclose(_np(lse), _np(want_lse), err_msg=msg,
                                       **TOL[dt])
        else:
            assert np.all(_np(lse) == np.float32(-1e30))
            np.testing.assert_allclose(_np(out), _np(v.float().mean(dim=2)
                                                     .repeat_interleave(G, 1)),
                                       err_msg=msg, **TOL[dt])
        oracle, _ = _jax_oracle(jq, jk, jv, jnp.asarray(cache_len, jnp.int32))
        np.testing.assert_allclose(_np(out), _np(oracle), err_msg=msg, **TOL[dt])


@pytest.mark.parametrize("G", [1, 2, 4])
def test_splitk_decode_partial_matches_pallas_backend(G):
    """The backend's split-KV form: out and lse as the reference's
    ``PallasSplitKAttention.decode_partial`` gives them, fp32."""
    arrays = _inputs(G, 32, seed=G)
    q, k, v = _as_torch(arrays, "float32")
    jq, jk, jv = _as_jax(arrays, "float32")
    port = TorchSplitKAttention(block_k=BLOCK_K, device="cpu")
    refb = PallasSplitKAttention(block_k=BLOCK_K, interpret=True)
    for cache_len in _edge_cache_lens(S):
        out, lse = port.decode_partial(q[:, None], k, v, cache_len)
        want, want_lse = refb.decode_partial(jq[:, None], jk, jv, cache_len)
        assert out.shape == (B, 1, KV * G, 32) and lse.shape == (B, 1, KV * G)
        np.testing.assert_allclose(_np(out), _np(want), **TOL["float32"])
        np.testing.assert_allclose(_np(lse), _np(want_lse), **TOL["float32"])


def test_plain_decode_paths_agree_and_split_kv_combines():
    """The kernel's plain version, the chunked scan and the dense oracle of
    ``models.attention`` give one answer, and lse-combining partials over
    two halves of the cache gives the whole cache's."""
    q, k, v = _as_torch(_inputs(2, 32, seed=5), "float32")
    for cache_len in (1, 9, S):
        out, lse = ref.decode_attention_ref(q, k, v, cache_len)
        for fn in (lambda: decode_attention(q[:, None], k, v, cache_len,
                                            kv_chunk=BLOCK_K, return_lse=True),
                   lambda: decode_attention_dense(q[:, None], k, v, cache_len,
                                                  return_lse=True)):
            o2, l2 = fn()
            torch.testing.assert_close(o2[:, 0], out, **TOL["float32"])
            torch.testing.assert_close(l2[:, 0], lse, **TOL["float32"])
        half = S // 2
        parts = [ref.decode_attention_ref(q, k[:, :, :half], v[:, :, :half],
                                          min(cache_len, half)),
                 ref.decode_attention_ref(q, k[:, :, half:], v[:, :, half:],
                                          max(cache_len - half, 0))]
        if cache_len <= half:  # an empty shard: weight 0 in the combine
            parts[1] = (parts[1][0], torch.full_like(parts[1][1], -1e30))
        merged = combine_split_kv_stacked(
            torch.stack([o[:, None] for o, _ in parts]),
            torch.stack([l[:, None] for _, l in parts]))
        torch.testing.assert_close(merged[:, 0], out, **TOL["float32"])


# (capacity S, B*KV) of the kernel's launches: the serving path's
# (internlm2-1.8b at batch 8 and prompt 512 + 32, its reduced config at
# batch 2), chip_smoke.py's (long cache, G 1 and G 4 at D 64) and the GPU
# tests'
PLAN_SHAPES = [(640, 64), (128, 4), (32768, 256), (300, 32), (300, 16),
               (200, 6), (1000, 4), (4096, 16), (128, 1024), (1, 1),
               # zamba2-7b's sites (B 8 x KV 32, D 112), seamless-m4t-medium's
               # self and cross caches (B 8 x KV 16)
               (640, 256), (1280, 128), (1024, 128)]


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("S,bkv", PLAN_SHAPES)
def test_split_plan_covers_every_key_once(S, bkv, sms):
    """Block j of a (b, kv) sweeps keys [j*split_keys, (j+1)*split_keys) of
    the capacity: every key in exactly one split, none past the capacity,
    whole 64-key tiles; at two resident blocks an SM (what the library
    reports for the serving shape's kernel on an H100), more than half of
    the splits one wave holds (up to one a tile), and no more than that
    or than splits of MAX_SPLIT_TILES tiles take.  A forced split count
    gets the same cover."""
    slots = 2 * sms
    tiles = -(-S // ops.SPLIT_TILE)
    for forced in (None, 1, 3, tiles + 5):
        n_split, split_keys = ops.split_plan(S, bkv, slots, n_split=forced)
        assert 1 <= n_split <= tiles
        assert split_keys % ops.SPLIT_TILE == 0
        covered = np.zeros(S, np.int64)
        for j in range(n_split):
            lo, hi = j * split_keys, min((j + 1) * split_keys, S)
            assert lo < hi
            covered[lo:hi] += 1
        assert np.all(covered == 1)
    n_split, split_keys = ops.split_plan(S, bkv, slots)
    one_wave = max(slots // bkv, 1)
    assert split_keys <= ops.MAX_SPLIT_TILES * ops.SPLIT_TILE
    assert n_split <= max(one_wave, -(-tiles // ops.MAX_SPLIT_TILES))
    assert 2 * n_split > min(one_wave, tiles)


def _split_merge(q, k, v, cache_len, n_split, split_keys):
    """The kernel's algorithm in torch: each split's partial (m, l, acc)
    over its range of the swept prefix (the valid keys, or the whole
    capacity when cache_len is 0, masked to -1e30), an empty range giving
    (-1e30, 0, 0); then the lse merge of the partials."""
    B, H, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    n = min(cache_len, S) if cache_len >= 1 else S
    qg = q.float().reshape(B, KV, G, D)
    ms, ls, accs = [], [], []
    for j in range(n_split):
        lo, hi = j * split_keys, min((j + 1) * split_keys, n)
        if lo >= hi:
            ms.append(torch.full((B, KV, G), -1e30))
            ls.append(torch.zeros(B, KV, G))
            accs.append(torch.zeros(B, KV, G, D))
            continue
        s = torch.einsum("bkgd,bksd->bkgs", qg, k[:, :, lo:hi].float()) / math.sqrt(D)
        t = torch.arange(lo, hi)
        s = torch.where(t < cache_len, s, torch.full_like(s, -1e30))
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgs,bksd->bkgd", p, v[:, :, lo:hi].float()))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    top = m.amax(0)
    w = torch.exp(m - top)
    lt = (l * w).sum(0).clamp_min(1e-30)
    out = (acc * w[..., None]).sum(0) / lt[..., None]
    return out.reshape(B, H, D), (top + torch.log(lt)).reshape(B, H)


@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_split_partials_merged_by_lse_match_the_plain_version(G):
    """The split-and-merge the kernel runs gives decode_attention_ref's out
    and lse at cache_len 0, 1, one key either side of a split boundary, and
    the full capacity (fp32, 1e-5)."""
    S, D = 200, 32
    rng = np.random.default_rng(G)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((2, 2 * G, D), (2, 2, S, D), (2, 2, S, D)))
    n_split, split_keys = ops.split_plan(S, 4, 132)
    assert n_split > 1
    edge = split_keys
    for L in (0, 1, edge - 1, edge, edge + 1, S - 1, S):
        out, lse = _split_merge(q, k, v, L, n_split, split_keys)
        want, want_lse = ref.decode_attention_ref(q, k, v, L)
        torch.testing.assert_close(out, want, **TOL["float32"])
        torch.testing.assert_close(lse, want_lse, **TOL["float32"])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2])
def test_d112_with_one_length_per_row_matches_the_pallas_kernel(G, dt):
    """zamba2-7b's head dim: the plain version with ``[B]`` lengths (0, the
    block edge, the capacity) against the Pallas kernel run row by row at
    each row's length (interpret mode)."""
    D, S_ = 112, 16
    rng = np.random.default_rng(G)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((3, KV * G, D), (3, KV, S_, D), (3, KV, S_, D))]
    q, k, v = _as_torch(arrays, dt)
    jq, jk, jv = _as_jax(arrays, dt)
    lens = torch.tensor([0, BLOCK_K, S_], dtype=torch.int32)
    out, lse = ops.decode_mha(q, k, v, lens)
    for b, n in enumerate(lens.tolist()):
        want, want_lse = ref_ops.decode_mha(
            jq[b:b + 1], jk[b:b + 1], jv[b:b + 1], jnp.asarray(n, jnp.int32),
            block_k=BLOCK_K, interpret=True)
        np.testing.assert_allclose(_np(out[b:b + 1]), _np(want), **TOL[dt])
        if n:
            np.testing.assert_allclose(_np(lse[b:b + 1]), _np(want_lse),
                                       **TOL[dt])


def test_kernel_shape_gate_takes_d112_without_launching():
    """The wrapper's gate takes zamba2's D 112 (and every D the CUDA
    dispatch has a case for, no other), and rejects D 96 and G 3; checking
    launches nothing."""
    before = dict(ops.LAUNCHES)
    assert 112 in ops.HEAD_DIMS
    for G in ops.GROUPS:
        for D in ops.HEAD_DIMS:
            ops.check_kernel_shape(G, D)
    with pytest.raises(ValueError, match="D in"):
        ops.check_kernel_shape(1, 96)
    with pytest.raises(ValueError, match="G = H/KV"):
        ops.check_kernel_shape(3, 112)
    assert ops.LAUNCHES == before
    source = ops._SOURCE.read_text()
    cases = {int(d) for d in __import__("re").findall(
        r"case (\d+): return f\(Type<T>\{\}, Int<G>\{\}, Int<\d+>", source)}
    assert cases == set(ops.HEAD_DIMS)


def test_cache_len_tensor_and_cpu_path_counts_no_launch():
    q, k, v = _as_torch(_inputs(2, 32, seed=1), "bfloat16")
    before = dict(ops.LAUNCHES)
    a = ops.decode_mha(q, k, v, 9)
    b = ops.decode_mha(q, k, v, torch.tensor([9], dtype=torch.int32))
    assert ops.LAUNCHES == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_wrapper_checks_its_operands():
    q, k, v = _as_torch(_inputs(2, 32, seed=1), "float32")
    with pytest.raises(TypeError, match="q is"):
        ops.decode_mha(q, k.bfloat16(), v, 3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.decode_mha(q.half(), k.half(), v.half(), 3)
    with pytest.raises(ValueError, match="does not fit"):
        ops.decode_mha(q[:, :3].contiguous(), k, v, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.decode_mha(q, k.transpose(2, 3), v, 3)
    with pytest.raises(TypeError, match="int32"):  # neither 1 nor B = 2
        ops.decode_mha(q, k, v, torch.tensor([3, 4, 5], dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        ops.decode_mha(q, k, v, torch.tensor([3, 4], dtype=torch.int64))


def test_splitk_rejects_unpadded_capacity():
    q, k, v = _as_torch(_inputs(2, 32, seed=1), "float32")
    be = TorchSplitKAttention(block_k=16, device="cpu")  # 24 % 16 != 0
    with pytest.raises(ValueError, match="not a multiple of"):
        be.decode(q[:, None], k, v, 5)


def test_library_path_keys_on_the_source(tmp_path, monkeypatch):
    """An edited source builds into a new directory: a stale library is
    never loaded."""
    p = ops.library_path()
    assert p.name == "libdecode_attention.so" and p.parent.parent.name == "build"
    edited = tmp_path / "decode_attention.cu"
    edited.write_bytes(ops._SOURCE.read_bytes() + b"// edited\n")
    monkeypatch.setattr(ops, "_SOURCE", edited)
    q = ops.library_path()
    assert q.parent.parent == p.parent.parent and q.parent != p.parent
