"""Wrapper of the hand-written split-KV decode kernel in
``csrc/decode_attention.cu``.

``decode_mha(q [B,H,D], k_cache, v_cache [B,KV,S,D], cache_len)``
→ ``(out [B,H,D] in q.dtype, lse [B,H] fp32)``: one token's attention over
the cache's first ``cache_len`` positions, the G = H / KV query heads of a
KV head sharing it.  ``cache_len`` is an int, an int32 tensor of one
element (one length for the batch) or an int32 tensor of B elements (row
``b`` attends to its own ``cache_len[b]`` keys, as the continuous-batching
scheduler's slots do), on the tensors' device; the kernel reads it there,
so a decode loop passes the same tensor arithmetic every step without a
host sync.

The kernel splits each (b, kv)'s cache across ``n_split`` blocks
(``split_plan``, from the capacity S, B·KV and the blocks the card holds
at once, never from ``cache_len``) and merges their partials by lse inside
the same launch: the last block of a (b, kv) to finish merges, found with
a ticket that it resets.  The partials and the tickets are scratch that the wrapper keeps
per device and stream, the tickets zeroed once: launches on one stream
run in order, and every launch leaves its tickets at zero.  A CUDA graph
captured on a stream holds that stream's scratch: warm the launch up on
the stream before the capture (the scratch cannot grow inside one), and
have the graph's owner take the scratch over with ``release_scratch``.

``decode_mha_paged(q, k_pages, v_pages, table, cache_len)`` is the same
attention over K and V left in the serving pool's pages: one layer's
``[num_blocks, KV, block_k, D]`` (each page's head a contiguous ``block_k x
D`` run; the page stride is free, so a layer's slice of the pool's buffer
goes as it is) and an int32 block table ``[B, table_width]`` on the
tensors' device, key t of row b at row ``t % block_k`` of page ``table[b, t
// block_k]``, over a capacity of ``table_width * block_k``.  It is the same
kernel template in its paged form, at the split plan of that capacity, and
gives the contiguous form's outputs over the gathered copy bit for bit.  A
tile of keys must lie in one page: the wrapper raises unless ``block_k`` is
a multiple of the tile's rows (``check_paged``).  The continuous-batching
scheduler's step calls it; ``generate``, the pipeline stages and the
sequence-sharded step call the contiguous form.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
goes to the kernel, or the wrapper raises.  There is no fallback from one
to the other.  The kernel is compiled with ``nvcc`` for ``sm_90a`` at first
use (``kernels/_build.py``) and loaded with ``ctypes``.  ``LAUNCHES`` counts
the kernel's launches (never the plain version's calls), the paged form's
under ``decode_attention_paged``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_paged_ref,
    decode_attention_ref,
)

__all__ = ["decode_mha", "decode_mha_paged", "decode_mha_cache_size",
           "launch", "launch_paged", "plan_for", "check_kernel_shape",
           "check_paged", "tile_rows", "LAUNCHES", "GROUPS",
           "HEAD_DIMS", "SPLIT_TILE", "MAX_SPLIT_TILES", "load_library",
           "library_path", "release_scratch", "split_plan"]

LAUNCHES = {"decode_attention": 0, "decode_attention_paged": 0}
GROUPS = (1, 2, 4, 8)       # query heads per KV head the kernel is built for
HEAD_DIMS = (32, 64, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_TILE = 64        # a split covers whole tiles of 64 keys
MAX_SPLIT_TILES = 16   # tiles of a split on a long cache

_HERE = Path(__file__).resolve().parent
_lib: Optional[ctypes.CDLL] = None
_SOURCE = _HERE / "csrc" / "decode_attention.cu"
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def library_path() -> Path:
    return _build.library_path(_SOURCE, _HERE / "build",
                               "libdecode_attention.so")


def _configure(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i,
                                            i, i, i, i, i, i, ctypes.c_float, p]
    lib.decode_attention_launch.restype = i
    lib.decode_attention_paged_launch.argtypes = [
        p, p, p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_longlong, i, i, i,
        i, i, ctypes.c_float, p]
    lib.decode_attention_paged_launch.restype = i
    lib.decode_attention_tile_rows.argtypes = [i, i, p]
    lib.decode_attention_tile_rows.restype = i
    lib.decode_attention_blocks_per_sm.argtypes = [i, i, i, p]
    lib.decode_attention_blocks_per_sm.restype = i
    lib.decode_attention_error_string.argtypes = [i]
    lib.decode_attention_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's shared library.
    The first call hashes the source; later calls return the loaded
    library without touching the disk."""
    global _lib
    if _lib is None:
        _lib = _build.load(_SOURCE, library_path(), _configure)
    return _lib


def split_plan(s_cap: int, bkv: int, slots: int,
               n_split: Optional[int] = None) -> Tuple[int, int]:
    """``(n_split, split_keys)`` for a capacity of ``s_cap`` keys, ``bkv`` =
    B·KV and ``slots`` blocks resident on the card at once: block ``j`` of a
    (b, kv) sweeps keys ``[j · split_keys, (j + 1) · split_keys)`` of the
    capacity, so the splits cover every key once, in whole
    ``SPLIT_TILE``-key tiles, none past the capacity.  As many splits as
    one resident wave holds (``slots // bkv``; a short cache is a latency
    chain, which a second wave lengthens), and at least enough for splits
    of ``MAX_SPLIT_TILES`` tiles (a long cache then runs as many short
    blocks, which leave no ragged last wave); or about ``n_split`` where it
    is given.  At least one split and at most one a tile.  ``cache_len``
    plays no part."""
    tiles = -(-s_cap // SPLIT_TILE)
    if n_split is None:
        n_split = max(slots // bkv, -(-tiles // MAX_SPLIT_TILES))
    n = max(1, min(n_split, tiles))
    per = -(-tiles // n)
    return -(-tiles // per), per * SPLIT_TILE


@functools.lru_cache(maxsize=None)
def _plan(s_cap: int, bkv: int, index: int, G: int, D: int,
          dtype: int) -> Tuple[int, int]:
    """``split_plan`` on device ``index``, once per shape: its SMs times the
    blocks of the kernel for G, D and dtype that one SM holds, as the
    library reports them."""
    blocks = ctypes.c_int()
    with torch.cuda.device(index):
        err = load_library().decode_attention_blocks_per_sm(
            G, D, dtype, ctypes.byref(blocks))
    _raise_on(err, "decode_attention_blocks_per_sm")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return split_plan(s_cap, bkv, max(1, blocks.value) * sms)


def plan_for(q: torch.Tensor, k_cache: torch.Tensor,
             s_cap: Optional[int] = None) -> Tuple[int, int]:
    """The ``(n_split, split_keys)`` that ``decode_mha`` launches these CUDA
    operands with; ``decode_mha_paged`` launches its pages (``k_cache``
    one layer's ``[num_blocks, KV, block_k, D]``) with the plan of its
    capacity ``s_cap``, the contiguous form's at that capacity."""
    B, H, D = q.shape
    KV = k_cache.shape[1]
    S = k_cache.shape[2] if s_cap is None else s_cap
    return _plan(S, B * KV, q.device.index, H // KV, D, _DTYPES[q.dtype])


@functools.lru_cache(maxsize=None)
def tile_rows(dtype: torch.dtype, D: int) -> int:
    """Keys of one tile of the paged kernel for ``dtype`` and head dim
    ``D``, as the library reports them (a power of two, at most
    ``SPLIT_TILE``): a paged launch needs ``block_k`` a multiple of it."""
    rows = ctypes.c_int()
    _raise_on(load_library().decode_attention_tile_rows(
        _DTYPES[dtype], D, ctypes.byref(rows)), "decode_attention_tile_rows")
    return rows.value


def decode_mha_cache_size() -> int:
    """The launch plans cached so far (one a capacity, B·KV, device, G, D
    and dtype; ``cache_len`` is not a key): a decode loop over a growing
    cache adds none after its first step, as the reference's jit cache
    adds no trace.  The plain version caches nothing."""
    return _plan.cache_info().currsize


def _raise_on(err: int, entry: str) -> None:
    if err != 0:
        msg = load_library().decode_attention_error_string(err).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {err} ({msg})")


def _scratch_for(dev: torch.device, stream: int, n_tickets: int,
                 n_part: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """At least ``n_tickets`` int32 zeros for the kernel's tickets (it
    leaves them zero) and ``n_part`` fp32 for its partials, one pair per
    device and stream, grown as needed."""
    key = (dev.index, stream)
    tickets, part = _scratch.get(key, (None, None))
    grow = ((tickets is None or tickets.numel() < n_tickets)
            or (part is None or part.numel() < n_part))
    if grow and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "decode_mha's scratch must grow inside a CUDA graph capture: "
            "launch it once at these shapes on the capturing stream first")
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=dev)
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=dev)
    _scratch[key] = (tickets, part)
    return tickets, part


def release_scratch(dev: torch.device, stream: int):
    """Forget the scratch kept for ``stream`` (a ``cuda_stream`` handle) on
    ``dev`` and return it, ``(tickets, partials)`` or ``None``.  A CUDA
    graph captured on that stream launches with these tensors' addresses,
    so its owner keeps them as long as the graph; torch reuses stream
    handles, and a later stream with this handle gets scratch of its own
    instead of growing, freeing or sharing the graph's."""
    dev = torch.device(dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return _scratch.pop((index, stream), None)


def _check(q, k_cache, v_cache):
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"q must be [B,H,D] and the caches [B,KV,S,D], got "
                         f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    B, H, D = q.shape
    if k_cache.shape != v_cache.shape:
        raise ValueError(f"k_cache {tuple(k_cache.shape)} != v_cache "
                         f"{tuple(v_cache.shape)}")
    kb, kv, s, kd = k_cache.shape
    if kb != B or kd != D or kv < 1 or H % kv or s < 1:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not fit q "
                         f"{tuple(q.shape)}: need [B, KV, S>=1, D] with KV | H")


def check_kernel_shape(G: int, D: int) -> None:
    """Raise unless the kernel is built for ``G`` = H/KV and head dim
    ``D`` (``GROUPS``, ``HEAD_DIMS``: the dispatch in
    ``csrc/decode_attention.cu``)."""
    if G not in GROUPS or D not in HEAD_DIMS:
        raise ValueError(f"decode_mha's kernel takes G = H/KV in {GROUPS} and "
                         f"D in {HEAD_DIMS}, got G={G}, D={D}")


def _len_tensor(cache_len, device: torch.device, batch: int) -> torch.Tensor:
    if isinstance(cache_len, torch.Tensor):
        if cache_len.dtype != torch.int32 or cache_len.numel() not in (1, batch):
            raise TypeError(f"cache_len must be an int32 tensor of 1 or B = "
                            f"{batch} elements, got {cache_len.dtype} "
                            f"{tuple(cache_len.shape)}")
        if cache_len.device != device:
            raise ValueError(f"cache_len is on {cache_len.device}, q on {device}")
        if not cache_len.is_contiguous():
            raise ValueError("cache_len must be contiguous")
        return cache_len
    return torch.tensor([int(cache_len)], dtype=torch.int32, device=device)


def check_paged(k_pages: torch.Tensor) -> None:
    """Raise (``ValueError``) unless the paged kernel takes one layer's pages
    ``k_pages [num_blocks, KV, block_k, D]`` on a CUDA device: a dtype and
    ``D`` it is built for, each page's head a contiguous ``block_k x D``
    run, 16-byte aligned pages, and ``block_k`` a multiple of the tile's
    rows (``tile_rows``: 32 or 64), so that no tile crosses a page.  The paged form's own check;
    ``G`` is checked where ``q`` is known (``check_kernel_shape``)."""
    if k_pages.dim() != 4:
        raise ValueError(f"pages must be [num_blocks, KV, block_k, D], got "
                         f"{tuple(k_pages.shape)}")
    if k_pages.dtype not in _DTYPES:
        raise ValueError(f"pages must be float32 or bfloat16, got {k_pages.dtype}")
    _, _, bk, D = k_pages.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_mha's kernel takes D in {HEAD_DIMS}, got {D}")
    if (k_pages.stride(3) != 1 or k_pages.stride(2) != D
            or k_pages.stride(1) != bk * D):
        raise ValueError(f"a page's heads must each be a contiguous block_k x "
                         f"D run, got strides {k_pages.stride()}")
    if (k_pages.data_ptr() % 16
            or k_pages.stride(0) * k_pages.element_size() % 16):
        raise ValueError("pages must be 16-byte aligned for the kernel")
    rows = tile_rows(k_pages.dtype, D)
    if bk % rows:
        raise ValueError(f"a tile of {rows} keys would cross a page of "
                         f"block_k={bk}: the paged kernel needs block_k a "
                         f"multiple of {rows} at {k_pages.dtype}, D {D}")


def _check_paged_operands(q, k_pages, v_pages, table):
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q must be [B,H,D] and the pages [num_blocks, KV, "
                         f"block_k, D], got {tuple(q.shape)} and "
                         f"{tuple(k_pages.shape)}")
    if v_pages.shape != k_pages.shape or v_pages.stride() != k_pages.stride():
        raise ValueError(f"v_pages {tuple(v_pages.shape)} {v_pages.stride()} "
                         f"!= k_pages {tuple(k_pages.shape)} {k_pages.stride()}")
    B, H, D = q.shape
    _, KV, _, kd = k_pages.shape
    if kd != D or KV < 1 or H % KV:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}: need [num_blocks, KV, block_k, D] "
                         f"with KV | H")
    if not isinstance(table, torch.Tensor) or table.dtype != torch.int32:
        raise TypeError(f"the block table must be an int32 tensor, got "
                        f"{getattr(table, 'dtype', type(table).__name__)}")
    if table.device != q.device:
        raise ValueError(f"the block table is on {table.device}, q on {q.device}")
    if table.dim() != 2 or table.shape[0] != B or table.shape[1] < 1:
        raise ValueError(f"the block table must be [B={B}, table_width >= 1], "
                         f"got {tuple(table.shape)}")
    if not table.is_contiguous() or not q.is_contiguous():
        raise ValueError("q and the block table must be contiguous")


def decode_mha_paged(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, table: torch.Tensor, cache_len):
    """One token's split-KV attention over K and V in pages, through the
    block table (see the module docstring) -> ``(out [B,H,D] in q.dtype,
    lse [B,H] fp32)``."""
    _check_paged_operands(q, k_pages, v_pages, table)
    dev = q.device
    lens = _len_tensor(cache_len, dev, q.shape[0])
    if dev.type == "cpu":
        return decode_attention_paged_ref(q, k_pages, v_pages, table, lens)
    if dev.type != "cuda":
        raise ValueError(f"decode_mha_paged runs on cpu or cuda, not {dev.type}")
    check_kernel_shape(q.shape[1] // k_pages.shape[1], q.shape[2])
    check_paged(k_pages)
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned for the kernel")
    s_cap = table.shape[1] * k_pages.shape[2]
    return launch_paged(q, k_pages, v_pages, table, lens,
                        plan_for(q, k_pages, s_cap))


def decode_mha(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               cache_len):
    """One token's split-KV attention on ``q``'s device (see the module
    docstring)."""
    _check(q, k_cache, v_cache)
    dev = q.device
    lens = _len_tensor(cache_len, dev, q.shape[0])
    if dev.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lens)
    if dev.type != "cuda":
        raise ValueError(f"decode_mha runs on cpu or cuda, not {dev.type}")
    check_kernel_shape(q.shape[1] // k_cache.shape[1], q.shape[2])
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the kernel")
    return launch(q, k_cache, v_cache, lens, plan_for(q, k_cache))


def launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           lens: torch.Tensor, plan: Tuple[int, int]):
    """The kernel's launch for ``decode_mha``, at the split plan ``plan`` =
    ``(n_split, split_keys)`` from ``split_plan``; operands as
    ``decode_mha`` has checked them, ``lens`` the int32 ``cache_len`` on
    their device.  ``decode_mha`` passes its own plan; a caller that
    measures plans passes others.  ``lens`` of B elements gives each row
    its own length; of one, the batch one length."""
    B, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    n_split, split_keys = plan

    def call(lib, stream, part, tickets, out, lse):
        return lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), out.data_ptr(), lse.data_ptr(), part, tickets,
            B, KV, H // KV, S, D, split_keys, n_split, _DTYPES[q.dtype],
            lens.numel(), 1.0 / math.sqrt(D), stream)

    return _run(q, KV, n_split, call, "decode_attention")


def launch_paged(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, table: torch.Tensor,
                 lens: torch.Tensor, plan: Tuple[int, int]):
    """The paged kernel's launch for ``decode_mha_paged`` at the split plan
    ``plan``; operands as ``decode_mha_paged`` has checked them."""
    B, H, D = q.shape
    KV, bk = k_pages.shape[1], k_pages.shape[2]
    n_split, split_keys = plan

    def call(lib, stream, part, tickets, out, lse):
        return lib.decode_attention_paged_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), lens.data_ptr(), out.data_ptr(), lse.data_ptr(),
            part, tickets, B, KV, H // KV, table.shape[1], bk,
            k_pages.stride(0), D, split_keys, n_split, _DTYPES[q.dtype],
            lens.numel(), 1.0 / math.sqrt(D), stream)

    return _run(q, KV, n_split, call, "decode_attention_paged")


def _run(q: torch.Tensor, KV: int, n_split: int, call, key: str):
    """Both forms' launch around ``call(lib, stream, part, tickets, out,
    lse)``: the outputs, the stream's scratch where the plan splits, the
    error check and the count under ``LAUNCHES[key]``."""
    B, H, D = q.shape
    dev = q.device
    out = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = part = None
        if n_split > 1:
            tickets, part = _scratch_for(dev, stream, B * KV,
                                         B * KV * n_split * (H // KV) * (D + 2))
        err = call(lib, stream, None if part is None else part.data_ptr(),
                   None if tickets is None else tickets.data_ptr(), out, lse)
    _raise_on(err, f"{key}_launch")
    LAUNCHES[key] += 1
    return out, lse
