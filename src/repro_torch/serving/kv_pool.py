"""Block-granular paged KV pool for the continuous-batching scheduler.

The :class:`repro_torch.core.backends.KVCacheLayout` already pads every
cache capacity to a ``block_k`` multiple at prefill, so the decode kernel's
``[L, B, KV, S, D]`` buffers are born block-aligned: paging falls out of the
existing blocks.  This module turns that alignment into an allocator:

* :class:`BlockAllocator`: a host-side free-list over ``num_blocks``
  physical pages.  Requests allocate ``layout.blocks_for(prompt + max_new)``
  pages at admission and free them at retirement; pages are reused without
  defragmenting (a block table makes any scatter of physical pages look
  contiguous to the decode step).
* :class:`KVBlockPool`: the device side, one buffer per *growing* KV leaf
  of the family cache (``ModelApi.cache_seq_axes`` classifies leaves), laid
  out ``[num_blocks, *rest, block_k, D]`` where one slot's leaf is
  ``[*rest, S, D]`` (``rest = (L, 1, KV)`` for every family), so one page's
  run of one layer and KV head is contiguous (``block_k x D``).  On one
  device the scheduler's step reads and writes the pages where they are:
  :meth:`KVBlockPool.paged` hands the family's ``decode_step`` each leaf as
  a ``models.kvcache.PagedKV`` (the pages, the block table and each slot's
  write row from :meth:`KVBlockPool.write_rows`), each layer writes its new
  K and V to its page (:meth:`KVBlockPool.scatter_token`) and the decode
  kernel's paged form reads the pages through the table (a backend
  without one gathers each layer's pages by the table).  Over a mesh
  ``gather`` still rebuilds the slots' contiguous caches from the block
  tables in one indexing kernel, shard-major ``[D, L, slots, KV, S_slot /
  D, D]`` (each shard one contiguous block of the same buffer), and
  ``scatter_token`` writes each slot's new K and V (read back with
  ``chunks_at``) to its page.

Trees are nested dicts and lists (the moe cache's ``stacks``) whose leaves
are tensors, with ``None`` at the leaves a half does not hold
(:func:`split_cache`).

Two physical pages are reserved:

* block 0, **null**: pads short block tables to the fixed table width.  It
  is never allocated and never written, so it stays zero; reads of it land
  at positions >= the request's ``length`` and are exactly masked out by
  the decode attention (score -> -1e30 -> probability exactly 0.0).
* block 1, **sink**: inactive slots' per-step writes are redirected here,
  so a retired slot can never corrupt a page that was freed and handed to
  a live request.  Its content is garbage by design and never read by an
  active slot.

Bitwise note: the differential suite
(``tests/test_torch_continuous_batching.py``) holds a request served in a
mixed stream to *bitwise* equality of tokens and logits with the same
request served alone.  That is only possible because masked positions
contribute exactly +0.0 to the attention sum whatever stale values a reused
page holds: the mask is applied to the scores before the softmax, so stale
K gives a -1e30 score (probability exactly 0.0, in the kernel's online
softmax too) and stale V is multiplied by that exact zero.  Freed-page
reuse therefore needs no zeroing.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.backends import KVCacheLayout
from repro_torch.core.spans import span
from repro_torch.models.kvcache import PagedKV

Tree = Any

NULL_BLOCK = 0
SINK_BLOCK = 1
RESERVED_BLOCKS = 2

__all__ = ["BlockAllocator", "KVBlockPool", "PoolExhausted",
           "NULL_BLOCK", "SINK_BLOCK", "RESERVED_BLOCKS",
           "split_cache", "merge_cache", "tree_map"]


class PoolExhausted(RuntimeError):
    """Raised when an admission asks for more pages than are free."""


class BlockAllocator:
    """Host-side free-list over the pool's physical pages.

    Invariants (property-tested in
    ``tests/test_torch_continuous_batching.py``): a page is never handed
    out twice while live, ``free`` rejects pages that are not live, and
    after every request retires the pool is back to fully free.  Reserved
    pages (null/sink) are never allocated.
    """

    def __init__(self, num_blocks: int, reserved: int = RESERVED_BLOCKS):
        if num_blocks <= reserved:
            raise ValueError(
                f"pool needs more than the {reserved} reserved blocks, "
                f"got num_blocks={num_blocks}")
        self.num_blocks = int(num_blocks)
        self.reserved = int(reserved)
        # LIFO free-list, seeded so pages are first handed out in ascending
        # id order (makes failures reproducible).
        self._free: List[int] = list(range(num_blocks - 1, reserved - 1, -1))
        self._live: set = set()

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        return len(self._live)

    def alloc(self, n: int) -> List[int]:
        if n <= 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} pages, only {len(self._free)} free "
                f"(pool={self.num_blocks}, live={len(self._live)})")
        ids = [self._free.pop() for _ in range(n)]
        self._live.update(ids)
        return ids

    def free(self, ids: Sequence[int]) -> None:
        for b in ids:
            if b not in self._live:
                raise ValueError(
                    f"double free / free of unallocated block {b}")
            self._live.discard(b)
            self._free.append(b)


def tree_map(fn: Callable, axes: Tree, *trees: Tree) -> Tree:
    """``fn(axis, *leaves)`` at every leaf of ``axes`` (a tree of
    ``Optional[int]`` from ``cache_seq_axes``), over trees of the same
    structure of dicts and lists."""
    if isinstance(axes, dict):
        return {k: tree_map(fn, axes[k], *(t[k] for t in trees)) for k in axes}
    if isinstance(axes, list):
        return [tree_map(fn, a, *(t[i] for t in trees))
                for i, a in enumerate(axes)]
    return fn(axes, *trees)


def split_cache(cache: Tree, seq_axes: Tree) -> Tuple[Tree, Tree]:
    """Split a family cache into (paged, slot_resident) by ``seq_axes``.
    Both halves keep the full tree structure; the complementary leaves are
    ``None``."""
    paged = tree_map(lambda ax, leaf: leaf if ax is not None else None,
                     seq_axes, cache)
    resident = tree_map(lambda ax, leaf: None if ax is not None else leaf,
                        seq_axes, cache)
    return paged, resident


def merge_cache(paged: Tree, resident: Tree, seq_axes: Tree) -> Tree:
    """Inverse of :func:`split_cache`."""
    return tree_map(lambda ax, p, r: p if ax is not None else r,
                    seq_axes, paged, resident)


@functools.lru_cache(maxsize=None)
def _arange(n: int, device: torch.device) -> torch.Tensor:
    """``arange(n)`` on ``device``, made once: an index the pool's steps
    reuse, so a step launches no kernel to rebuild it."""
    return torch.arange(n, device=device)


def _words(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its last dim reinterpreted as int64 words where its bytes
    allow: a gather then moves the same bits as a quarter (bf16) or half
    (fp32) as many elements, which the card's indexing kernel copies
    faster."""
    if t.element_size() < 8 and t.shape[-1] * t.element_size() % 8 == 0:
        return t.view(torch.int64)
    return t


@dataclasses.dataclass
class KVBlockPool:
    """Device-side paged storage for the growing KV leaves of one family.

    ``buffers`` mirrors the cache tree with ``None`` at slot-resident
    leaves; each paged leaf is ``[num_blocks, L, 1, *mid, block_k, D]`` for
    one slot's leaf ``[L, 1, *mid, S, D]`` (the batch axis second, as every
    cache leaf of the port has it; seq axis -2).  ``table_width`` fixes the
    block-table width (``S_slot = table_width * block_k`` is the capacity
    every slot has), so admission and retirement never change a shape the
    decode step sees.
    """

    layout: KVCacheLayout
    num_blocks: int
    table_width: int
    seq_axes: Tree
    buffers: Tree
    allocator: BlockAllocator

    @classmethod
    def build(cls, slot_cache_template: Tree, seq_axes: Tree,
              layout: KVCacheLayout, num_blocks: int) -> "KVBlockPool":
        """Allocate zeroed pool buffers, on the template's device, for one
        slot's cache template (a B = 1 cache) whose paged leaves have the
        pool's slot capacity ``S_slot`` at axis -2."""
        bk = max(1, int(layout.block_k))
        widths = set()

        def mk(ax, leaf):
            if ax is None:
                return None
            if ax != -2 or leaf.dim() < 5 or leaf.shape[1] != 1:
                raise ValueError(
                    f"a paged leaf is one slot's [L, 1, ..., S, D] with its "
                    f"sequence at axis -2, got axis {ax} of "
                    f"{tuple(leaf.shape)}")
            s = leaf.shape[-2]
            layout.check_capacity(s)
            widths.add(s // bk)
            return torch.zeros((num_blocks,) + tuple(leaf.shape[:-2])
                               + (bk, leaf.shape[-1]), dtype=leaf.dtype,
                               device=leaf.device)

        buffers = tree_map(mk, seq_axes, slot_cache_template)
        if len(widths) > 1:
            raise ValueError(
                f"paged leaves disagree on capacity: {sorted(widths)} blocks")
        # Attention-free families (ssm) have no growing KV: a zero-width
        # pool whose admit/retire/gather/scatter degrade to no-ops.
        width = widths.pop() if widths else 0
        return cls(layout=layout, num_blocks=num_blocks, table_width=width,
                   seq_axes=seq_axes, buffers=buffers,
                   allocator=BlockAllocator(num_blocks))

    @property
    def block_k(self) -> int:
        return max(1, int(self.layout.block_k))

    # -- host-side admission/retirement -----------------------------------

    def admit(self, cache: Tree, max_len: int) -> np.ndarray:
        """Allocate pages for a request needing capacity ``max_len`` and copy
        its prefilled KV (the paged half of a B = 1 cache) into them.
        Returns the request's block table (int32 ``[table_width]``, padded
        with the null block)."""
        if self.table_width == 0:
            return np.zeros((0,), np.int32)
        n = self.layout.blocks_for(max_len)
        if n > self.table_width:
            raise ValueError(
                f"request needs {n} pages but tables hold {self.table_width}")
        with span("kv_pool.admit"):
            ids = self.allocator.alloc(n)
            bk = self.block_k

            def write(ax, buf, leaf):
                if ax is None:
                    return buf
                # [*rest, S, D] -> per-page chunks [n, *rest, bk, D]
                x = leaf[..., : n * bk, :]
                x = x.reshape(tuple(x.shape[:-2]) + (n, bk, x.shape[-1]))
                x = x.movedim(-3, 0)
                with span("kv_pool.sync"):
                    idx = torch.tensor(ids, dtype=torch.long,
                                       device=buf.device)
                return buf.index_copy_(0, idx, x.to(buf.dtype))

            tree_map(write, self.seq_axes, self.buffers, cache)
        table = np.full((self.table_width,), NULL_BLOCK, np.int32)
        table[:n] = ids
        return table

    def retire(self, table: np.ndarray, n_blocks: int) -> None:
        """Free a retired request's pages (the first ``n_blocks`` table
        entries; the rest are null padding)."""
        self.allocator.free([int(b) for b in table[:n_blocks]])

    # -- device-side step: paged leaves, writes, gather (inside the graph) --

    def write_rows(self, tables: torch.Tensor, positions: torch.Tensor,
                   active: torch.Tensor):
        """Where each slot writes the token at ``positions[slot]``: ``(page,
        offset)``, two int64 ``[slots]`` tensors, the page from the slot's
        row of ``tables`` (int ``[slots, table_width]``) and the offset in
        it.  Inactive slots are redirected to the sink page so they can
        never touch a re-allocated one; their block index is clipped to the
        table, as their (discarded) positions grow past it.  Two active
        slots never collide (they own disjoint pages); sink collisions are
        harmless because the sink is never read by an active slot."""
        bk = self.block_k
        slots, width = tables.shape
        pos = positions.long()
        block_ix = (pos // bk).clamp(0, width - 1)
        page = tables[_arange(slots, tables.device), block_ix].long()
        page = torch.where(active, page, SINK_BLOCK)
        return page, pos % bk

    def paged(self, tables: torch.Tensor, rows) -> Tree:
        """The paged half of the cache tree for a batch of the slots, left
        in the pages: each leaf a ``PagedKV`` over its buffer (``[num_blocks,
        L, *mid, block_k, D]``, the batch axis dropped), the int32 block
        table ``tables [slots, table_width]`` and the step's write rows
        (:meth:`write_rows`), written through :meth:`scatter_token`."""
        return tree_map(
            lambda ax, buf: None if ax is None else PagedKV(
                pages=buf.select(2, 0), table=tables, rows=rows,
                scatter=self.scatter_token),
            self.seq_axes, self.buffers)

    def scatter_token(self, buffers, chunks, rows):
        """Write each slot's newly decoded K and V to its page, in place, at
        ``rows`` (:meth:`write_rows`); returns ``buffers``.

        ``buffers`` is the pool's tree with ``chunks`` a paged tree of
        ``[L, slots, *mid, D]`` leaves (the step's write, from
        :meth:`chunks_at`), or one layer's pages ``[num_blocks, *mid,
        block_k, D]`` of a ``PagedKV`` with ``chunks`` ``[slots, *mid, D]``
        (the layer's write inside the step)."""
        if isinstance(buffers, torch.Tensor):
            _put(buffers, chunks, rows)
            return buffers

        def s(ax, buf, chunk):
            if ax is not None:
                _put(buf.select(2, 0), chunk.movedim(1, 0), rows)
            return buf

        tree_map(s, self.seq_axes, buffers, chunks)
        return buffers

    def gather(self, buffers: Tree, tables: torch.Tensor,
               shards: int = 0) -> Tree:
        """Rebuild contiguous per-slot caches from block tables.

        ``tables``: int ``[slots, table_width]`` on the pool's device.
        Returns the paged half of the cache tree for a batch of the slots:
        ``[L, slots, *mid, S_slot, D]`` per leaf, the layout the decode
        kernel's contiguous form reads, made by one indexing kernel (no
        transpose after it).  With ``shards`` = D >= 1, the S axis split
        into D sequence shards, shard-major: ``[D, L, slots, *mid, S_slot /
        D, D]``, shard ``d`` holding positions ``[d · S_slot / D, (d + 1) ·
        S_slot / D)``, so each shard's ``[L, slots, *mid, S_slot / D, D]`` is
        one contiguous block (the decode kernel takes it as it is), from the
        same one kernel and the same bytes.  Launches kernels only: no host
        sync, so a CUDA graph can hold it.
        """
        bk = self.block_k
        slots, width = tables.shape
        S = width * bk
        n = max(1, int(shards))
        if S % n:
            raise ValueError(f"a capacity of {S} does not split into "
                             f"{n} sequence shards")
        dev = tables.device

        def shard_major(x):   # [slots, S] -> [n, 1, slots, 1, S/n], contiguous
            return x.reshape(slots, n, S // n).transpose(0, 1).reshape(
                n, 1, slots, 1, S // n).contiguous()

        page = shard_major(tables.long()[:, :, None].expand(slots, width, bk))
        off = shard_major((_arange(S, dev) % bk).expand(slots, S))

        def g(ax, buf):
            if ax is None:
                return None
            nb, L = buf.shape[:2]
            M = math.prod(buf.shape[3:-2])
            src = _words(buf.view(nb, L, M, bk, buf.shape[-1]))
            out = src[page, _arange(L, dev).view(1, L, 1, 1, 1),
                      _arange(M, dev).view(1, 1, 1, M, 1), off].view(buf.dtype)
            shape = ((L, slots) + tuple(buf.shape[3:-2])
                     + (S // n, buf.shape[-1]))
            return out.view((n,) + shape) if shards else out.view(shape)

        return tree_map(g, self.seq_axes, buffers)

    def chunks_at(self, paged: Tree, positions: torch.Tensor) -> Tree:
        """The K and V each slot wrote this step: sequence position
        ``positions[slot]`` of every gathered leaf ``[L, slots, *mid, S,
        D]`` -> ``[L, slots, *mid, D]``, on the pool's device.  Positions
        are clipped to the capacity, as the write in ``decode_step`` clips
        them.  A leaf that is a list of D sequence shards (``[L, slots,
        *mid, S / D, D]`` each, the sharded step's) is read on the shard
        that owns each slot's position."""

        def at(leaf, pos):
            L, slots = leaf.shape[:2]
            S, D = leaf.shape[-2:]
            M = math.prod(leaf.shape[2:-2])
            dev = leaf.device
            pos = pos.to(dev).view(1, slots, 1)
            out = leaf.reshape(L, slots, M, S, D)[
                _arange(L, dev).view(L, 1, 1), _arange(slots, dev).view(1, slots, 1),
                _arange(M, dev).view(1, 1, M), pos]
            return out.view(tuple(leaf.shape[:-2]) + (D,))

        def one(ax, leaf):
            if ax is None:
                return None
            if isinstance(leaf, torch.Tensor):
                return at(leaf, positions.long().clamp(max=leaf.shape[-2] - 1))
            s_loc = leaf[0].shape[-2]
            pos = positions.long().clamp(max=s_loc * len(leaf) - 1)
            owner, local = pos // s_loc, pos % s_loc
            out = at(leaf[0], local).to(positions.device)
            for d, shard in enumerate(leaf[1:], start=1):
                mine = (owner == d).view((1, -1) + (1,) * (out.dim() - 2))
                out = torch.where(mine, at(shard, local).to(out.device), out)
            return out

        return tree_map(one, self.seq_axes, paged)


def _put(pages: torch.Tensor, new: torch.Tensor, rows) -> None:
    """``new [slots, *lead, D]`` into ``pages [num_blocks, *lead, block_k,
    D]`` at each slot's ``rows`` = (page, offset), in place."""
    page, offset = rows
    pages[page, ..., offset, :] = new.to(pages.dtype)
