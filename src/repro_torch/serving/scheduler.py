"""Continuous-batching request scheduler over a paged KV pool.

The static ``ServingEngine.generate`` pads one batch to one length and
shares one ``cache_len`` across every request.  This module serves a
stream instead, with admission control:

* a fixed-slot decode batch (``num_slots``): one decode step whose shapes
  never change, so admitting or retiring a request only writes the step's
  inputs in place.  On a CUDA card the step is captured once in a
  :class:`torch.cuda.CUDAGraph` and replayed every step (``captures`` stays
  at 1 over the scheduler's life, the port's form of the reference's
  ``_step_fn._cache_size() == 1``); on the CPU the same step runs eagerly;
* per-slot caches read each step from the :class:`KVBlockPool`'s pages
  through block tables, so a request's pages are scattered physically but
  contiguous logically (defrag-free reuse);
* per-slot ``length``: the step runs the family's ``decode_step`` over all
  slots at once with one length per slot (``cache["length"]`` of shape
  ``[slots]``, and the encdec family's ``src_length`` likewise), where the
  reference maps a B = 1 step over the slots with ``jax.vmap``; the decode
  kernel reads one length per batch row, and the moe family's step routes
  each row as its own token group;
* requests admitted mid-decode as slots free up, retired the step their
  token budget completes; admission order is FIFO over (arrival, rid);
* each admission's B = 1 prefill, for a family whose prefill pads
  (``ModelApi.prefill_pads``: dense, vlm, and moe without a capacity), run
  at the prompt's length bucket (:func:`prefill_buckets`: powers of two
  from 16, then the slot capacity) with the prompt padded at its end
  (``prefill(..., n_valid=)``); where the step is graphed,
  from a CUDA graph captured per bucket at construction beside the
  step's, else the same padded prefill eagerly.  An eager prefill is a
  chain of small launches, one op at a time, so the host, not the card,
  sets its pace; a replay is one launch.  The graph reads a static token
  buffer, the real length n as a device scalar (and, for vlm, the
  frontend rows) and returns the logits of position n - 1 and a cache of
  length n (``transformer.prefill(..., n_valid=)``), so one graph serves
  every prompt of its bucket.  Padding is exact: the padded positions
  come after every real one, so causal attention keeps them out of every
  real position's result, and their K and V land in the slot's pages at
  positions >= its length, which the decode step masks to an exact zero
  and overwrites one a step.  The moe family at a capacity, ssm, hybrid
  and encdec keep the unpadded eager prefill;
* over a mesh (``mesh``, ``axis_name``), the sequence-sharded step: the
  pool gathers the paged leaves shard-major, the S axis split into one
  slice a device along ``axis_name`` (each a contiguous block, no copy on
  a mesh that repeats the scheduler's device), and the family's
  ``decode_step(..., seq_shard_axes=...)`` writes the new token on the
  shard that owns its position, runs the decode backend once a shard and
  merges the partials by lse (``models/attention.py::
  sharded_decode_attend``).  The slot capacity must split into D whole
  ``block_k`` blocks; a capacity that does not raises.

On one device the step is the slots' write rows (each slot's page from its
block table and the offset in it, an inactive slot's on the sink page),
then ``decode_step`` over the pool's pages (``KVBlockPool.paged``: each
layer writes its new K and V to its page and attention reads the pages
through the table, ``transformer._decode_attn``), then argmax; the step
makes no contiguous copy of the cache.  Over a mesh the step is the pool's
gather into contiguous shards, ``decode_step``, the write of each slot's
new K and V to its page, then argmax; ``gather_steps`` counts the steps
that gathered.  No operation in the step synchronises with the host, and
outputs that it makes as new tensors (``length + 1``, the logits, the next
tokens) are copied into the scheduler's own tensors, which the graph
holds.  Only admission and retirement upload the block tables and the
active mask.  The tokens each
step emits stay on the device until the stream ends.  Each step's launch,
admission and retirement run under the spans ``scheduler.step``,
``scheduler.admit`` and ``scheduler.retire``, each copy to the card that
waits for it under ``scheduler.sync`` (``core/spans.py``), so that a
profiler's trace times them on the card's clock.

Bitwise contract (``tests/test_torch_cb_*.py``): a request
served in a mixed stream gives the same tokens and final-step logits, bit
for bit, as the same request served alone through a scheduler with the
same ``num_slots`` and slot capacity: the step's products run at M =
``num_slots`` either way, a prompt prefills at the same bucket either way,
a row never reads another, and masked positions contribute exactly +0.0
whatever stale values reused pages hold (see ``kv_pool.py``).  Against
``generate`` at B = 1, whose products run at M = 1 and whose prefill is
unpadded, the tokens are identical and the logits agree within 1e-4.  The
sharded step at D = 1 is bit for bit the unsharded one (the merge of one
partial is exact); at D > 1 the partial sums are reordered, so tokens
are held equal and logits within 2e-2 (``tests/test_torch_sharded_*``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.backends import KVCacheLayout
from repro_torch.core.spans import span
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.models.registry import FRONTEND_INPUTS
from repro_torch.serving.engine import extra_tensors
from repro_torch.serving.kv_pool import (
    RESERVED_BLOCKS,
    KVBlockPool,
    merge_cache,
    split_cache,
    tree_map,
)

__all__ = ["Request", "RequestResult", "RequestScheduler",
           "prefill_buckets", "prefill_bucket"]

WARMUP_STEPS = 2  # eager steps on the capture stream before the capture
PREFILL_BUCKET_MIN = 16  # the smallest prompt-length bucket


def prefill_buckets(capacity: int, frontend: int = 0) -> List[int]:
    """The prompt-length buckets of the padded prefill in a slot of
    ``capacity``: the powers of two from ``PREFILL_BUCKET_MIN`` below the
    capacity, then the capacity.  A prompt's length counts its
    ``frontend`` rows (vlm's image embeddings before its tokens), so a
    bucket of ``frontend`` or fewer positions holds no prompt and is left
    out."""
    out, b = [], PREFILL_BUCKET_MIN
    while b < capacity:
        if b > frontend:
            out.append(b)
        b *= 2
    return out + [int(capacity)]


def prefill_bucket(n: int, buckets: Sequence[int]) -> int:
    """The smallest of ``buckets`` (ascending) that holds ``n`` positions."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"a prompt of {n} positions exceeds the largest "
                     f"bucket, {buckets[-1]}")


@dataclasses.dataclass
class Request:
    """One generation request in the stream."""

    rid: int
    prompt: np.ndarray                 # [S_prompt] int32
    max_new_tokens: int
    extra: Optional[Dict[str, np.ndarray]] = None  # vlm embeds / encdec frames
    arrival: int = 0                   # earliest scheduler step for admission


@dataclasses.dataclass
class RequestResult:
    """Per-request output, comparable to the static path: ``tokens``
    matches ``GenerationResult.tokens[r]`` and ``final_logits`` matches
    ``GenerationResult.prefill_logits[r]`` (the last decode step's
    logits)."""

    rid: int
    tokens: np.ndarray                 # [max_new_tokens] int32
    final_logits: np.ndarray           # [vocab] fp32: last decode step's logits
    prompt_len: int
    admitted_step: int
    finished_step: int


@dataclasses.dataclass
class _Slot:
    request: Request
    slot: int
    table: np.ndarray
    n_blocks: int
    first: int                         # the token log's row of its first token
    admitted_step: int
    emitted: int = 0


class RequestScheduler:
    """Continuous batching over ``num_slots`` fixed decode slots.

    ``model`` is a :class:`repro_torch.models.registry.ModelApi` and
    ``params`` its module.  ``slot_capacity`` is the per-slot cache
    capacity: every admitted request prefills (``model.prefill``) at it, so
    the step's shapes are constant; it must be a ``layout.block_k``
    multiple.  ``num_blocks=None`` sizes the pool for full occupancy
    (every slot holding a maximal request) plus the two reserved pages.

    ``device``: where the params live and the step runs, ``"cuda"`` by
    default (which raises where no card is present) or ``"cpu"``.
    ``graph``: capture the step in a CUDA graph (default: on CUDA, where
    every entry of the mesh, if any, is ``device``); a failed capture
    raises.  ``graph=False`` runs the same step eagerly.

    A family whose prefill pads (``ModelApi.prefill_pads``) prefills each
    admitted prompt padded to its bucket (:func:`prefill_buckets`), from a
    CUDA graph captured per bucket where ``graph`` is on, eagerly where it
    is off: the same ops either way, so graph = eager bit for bit.

    ``mesh``/``axis_name``: the sequence-sharded step over the mesh's
    devices along ``axis_name`` (:class:`repro_torch.launch.mesh.Mesh`);
    shards on another device than ``device`` get a copy of their slice
    each step, and such a step runs eagerly.
    """

    def __init__(self, model, params, num_slots: int, slot_capacity: int,
                 layout: Optional[KVCacheLayout] = None,
                 num_blocks: Optional[int] = None, device="cuda",
                 graph: Optional[bool] = None, mesh=None,
                 axis_name: str = "seq"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "RequestScheduler runs on a CUDA device by default and none "
                "is available; pass device='cpu' to serve on the CPU")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"RequestScheduler runs on cuda or cpu, not {device!r}")
        self.mesh, self.axis_name = mesh, axis_name
        # the shards: the mesh's devices along axis_name, as a 1-D mesh
        self._seq_mesh = None if mesh is None else mesh.axis_mesh(axis_name)
        local = (mesh is None or all(
            d.type == self.device.type
            and (d.index or 0) == (self.device.index or 0)
            for d in self._seq_mesh.flat()))
        self.graph = (self.device.type == "cuda" and local if graph is None
                      else bool(graph))
        if self.graph and self.device.type != "cuda":
            raise ValueError("a CUDA graph of the step needs device='cuda'")
        if self.graph and not local:
            raise ValueError("a CUDA graph of the sharded step needs every "
                             "mesh entry on the scheduler's device")
        p = next(iter(params.parameters()))
        if p.device.type != self.device.type:
            raise ValueError(f"params are on {p.device}, the scheduler on "
                             f"{self.device}")
        self.model = model
        self.params = params
        self.num_slots = int(num_slots)
        self.layout = layout or KVCacheLayout()
        self.layout.check_capacity(slot_capacity)
        self.slot_capacity = int(slot_capacity)
        if mesh is not None:
            self.check_capacity(self.slot_capacity)
        if num_blocks is None:
            num_blocks = (RESERVED_BLOCKS + self.num_slots
                          * self.layout.blocks_for(slot_capacity))

        # The pool and the stacked slot state from one template prefill
        # (shapes only matter; a 1-token prompt is the cheapest, with the
        # frontend's zero embeddings where the family takes them).
        logits, template = model.prefill(
            params, {"tokens": torch.zeros((1, 1), dtype=torch.long,
                                           device=self.device),
                     **self._template_extra()},
            self.slot_capacity)
        self.seq_axes = model.cache_seq_axes(template)
        self.pool = KVBlockPool.build(template, self.seq_axes, self.layout,
                                      num_blocks)
        if mesh is not None and self.pool.table_width == 0:
            raise ValueError(f"family {model.cfg.family!r} has no growing KV "
                             f"cache to shard over a mesh")
        S = self.num_slots

        def stacked(ax, leaf):
            # a scalar (length) becomes [slots]; [L, 1, ...] becomes
            # [L, slots, ...]: the batch axis of the family's cache
            if ax is not None:
                return None
            if leaf.dim() == 0:
                return torch.zeros((S,), dtype=leaf.dtype, device=self.device)
            if leaf.shape[1] != 1:
                raise ValueError(f"a slot-resident leaf is [L, 1, ...] for "
                                 f"one slot, got {tuple(leaf.shape)}")
            return torch.zeros((leaf.shape[0], S) + tuple(leaf.shape[2:]),
                               dtype=leaf.dtype, device=self.device)

        # The step's inputs and outputs, written in place: a captured graph
        # reads and writes these very tensors.
        self._state = tree_map(stacked, self.seq_axes, template)
        self._tokens = torch.zeros((S, 1), dtype=torch.long, device=self.device)
        self._logits = torch.zeros((S, logits.shape[-1]), dtype=logits.dtype,
                                   device=self.device)
        self._tables = np.zeros((S, self.pool.table_width), np.int32)
        self._active = np.zeros((S,), bool)
        self._tables_dev = torch.zeros((S, self.pool.table_width),
                                       dtype=torch.int32, device=self.device)
        self._active_dev = torch.zeros((S,), dtype=torch.bool,
                                       device=self.device)
        self._slots: List[Optional[_Slot]] = [None] * S
        self.steps_run = 0          # decode steps executed (utilization)
        self.gather_steps = 0       # of them, the steps that ran the pool's gather
        self._gathers = self.mesh is not None and self.pool.table_width > 0
        self.tokens_emitted = 0
        self.captures = 0           # CUDA graphs captured: 1 on CUDA, 0 eager
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_scratch = None  # the decode kernel's scratch the graph holds

        # The padded prefill's static inputs: a prompt's tokens (each bucket
        # reads a prefix), its real length n and, for vlm, its frontend rows
        # in the embeddings' dtype (``embed_with_extra`` casts them to it).
        self.prefill_captures = 0   # prefill graphs captured, one a bucket
        self.prefill_replays = 0    # admissions served from a prefill graph
        # bucket -> (its graph, the graph's outputs)
        self._prefill_graphs: Dict[int, tuple] = {}
        if model.prefill_pads:
            self._frontend = self.model.cfg.frontend_tokens or 0
            self._buckets = prefill_buckets(self.slot_capacity, self._frontend)
            self._pf_tokens = torch.zeros((1, self.slot_capacity),
                                          dtype=torch.long, device=self.device)
            self._pf_n = torch.zeros((), dtype=torch.int32, device=self.device)
            self._pf_extra = {
                key: torch.zeros_like(t, dtype=params.embed.dtype)
                for key, t in self._template_extra().items()}
        if self.graph:
            self._capture()

    def check_capacity(self, slot_capacity: int) -> None:
        """Raise unless ``slot_capacity`` splits into D (the mesh's size
        along ``axis_name``) slices of whole ``layout.block_k`` blocks:
        each shard's slice is a capacity the decode backend takes as it
        is.  Nothing is padded to make it split."""
        D, bk = self._seq_mesh.size, max(1, int(self.layout.block_k))
        if slot_capacity % (D * bk):
            raise ValueError(
                f"slot capacity {slot_capacity} does not split into {D} "
                f"sequence shards of whole block_k={bk} blocks; pick "
                f"max_request_len so that the capacity is a multiple of "
                f"{D * bk}")

    # ------------------------------------------------------------------ #
    # the fixed-shape step

    def _step_body(self) -> None:
        """One decode step over every slot, reading and writing only the
        scheduler's own tensors and the pool's pages."""
        state, pool = self._state, self.pool
        if self.mesh is None:
            rows = (pool.write_rows(self._tables_dev, state["length"],
                                    self._active_dev)
                    if pool.table_width else None)
            cache = merge_cache(pool.paged(self._tables_dev, rows), state,
                                self.seq_axes)
            logits, new_cache = self.model.decode_step(self.params,
                                                       self._tokens, cache)
            self._keep(logits, split_cache(new_cache, self.seq_axes)[1])
            return
        positions = state["length"].clone()                  # [slots]
        devices = self._seq_mesh.flat()
        paged = tree_map(
            lambda ax, leaf: None if ax is None else [
                t.to(d) for t, d in zip(leaf.unbind(0), devices)],
            self.seq_axes,
            pool.gather(pool.buffers, self._tables_dev, shards=len(devices)))
        cache = merge_cache(paged, state, self.seq_axes)
        logits, new_cache = self.model.decode_step(
            self.params, self._tokens, cache, seq_shard_axes=self._seq_mesh)
        new_paged, new_state = split_cache(new_cache, self.seq_axes)
        if pool.table_width:  # an attention-free family pages nothing
            pool.scatter_token(pool.buffers,
                               pool.chunks_at(new_paged, positions),
                               pool.write_rows(self._tables_dev, positions,
                                               self._active_dev))
        self._keep(logits, new_state)

    def _keep(self, logits: torch.Tensor, new_state) -> None:
        """The step's outputs into the scheduler's own tensors: the
        slot-resident state, the logits and the next tokens (argmax)."""

        def keep(ax, old, new):
            if ax is None and new is not old:
                old.copy_(new)

        tree_map(keep, self.seq_axes, self._state, new_state)
        self._logits.copy_(logits[:, -1])
        self._tokens.copy_(logits[:, -1:].argmax(dim=-1))

    def _prefill_at(self, bucket: int):
        """The padded prefill of ``bucket`` positions over the static
        inputs: the frontend rows, the token buffer's first ``bucket`` less
        the frontend rows, the real length n.  Returns the logits of
        position n - 1 and the cache, of length n.  Every input is
        rewritten for each admission: ``run`` refuses a request without
        the family's frontend rows."""
        batch = {"tokens": self._pf_tokens[:, :bucket - self._frontend],
                 **self._pf_extra}
        return self.model.prefill(self.params, batch, self.slot_capacity,
                                  n_valid=self._pf_n)

    def _capture_prefills(self, stream) -> None:
        """Capture the padded prefill of every bucket on ``stream``, each
        after an eager warm-up there, from the largest down into one memory
        pool: a graph's temporaries reuse what the larger ones freed, and
        each keeps only its outputs (the logits and a cache at the slot
        capacity).  So a replay may overwrite another bucket's outputs:
        replays run in stream order, and each admission has paged in its
        outputs before the next replay."""
        pool = torch.cuda.graph_pool_handle()
        for bucket in reversed(self._buckets):
            with torch.cuda.stream(stream):
                self._pf_n.fill_(bucket)
                self._prefill_at(bucket)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                out = self._prefill_at(bucket)
            self._prefill_graphs[bucket] = (graph, out)
            self.prefill_captures += 1

    def _capture(self) -> None:
        """Capture the padded prefill's graphs, where the family pads
        (:meth:`_capture_prefills`), then warm the step up on the same side
        stream (the decode wrapper's split plan and its per-stream scratch
        are made there, and the kernel leaves its tickets at zero) and
        capture it once on that stream.  Every slot is vacant, so the
        warm-up only writes what admission overwrites.  The graph holds the
        addresses of the scratch the wrapper kept for that stream, so the
        scheduler takes it over (``decode_ops.release_scratch``): a later
        stream that gets the same handle from torch's pool gets scratch of
        its own, and the graph's lives as long as the graph.  Nothing is
        captured later: a stream's admissions and steps only replay."""
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        if self.model.prefill_pads:
            self._capture_prefills(stream)
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_STEPS):
                self._step_body()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            self._step_body()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self._graph_scratch = decode_ops.release_scratch(self.device,
                                                         stream.cuda_stream)
        self._graph = graph
        self.captures += 1

    def _launch_step(self) -> None:
        with span("scheduler.step"):
            if self._graph is None:
                self._step_body()
            else:
                self._graph.replay()

    def _template_extra(self) -> Dict[str, torch.Tensor]:
        cfg = self.model.cfg
        key = FRONTEND_INPUTS.get(cfg.family)
        if key is None:
            return {}
        return {key: torch.zeros((1, cfg.frontend_tokens, cfg.d_model),
                                 dtype=torch.bfloat16, device=self.device)}

    # ------------------------------------------------------------------ #
    # host-side admission / retirement

    def _need(self, req: Request) -> int:
        return (len(np.asarray(req.prompt).reshape(-1)) + req.max_new_tokens
                + (self.model.cfg.frontend_tokens or 0))

    def _upload(self) -> None:
        """The block tables and the active mask to the card: copies from
        pageable host memory, each of which waits for the card's stream."""
        with span("scheduler.sync"):
            self._tables_dev.copy_(torch.from_numpy(self._tables))
        with span("scheduler.sync"):
            self._active_dev.copy_(torch.from_numpy(self._active))

    def _prefill(self, req: Request):
        """The admitted prompt's B = 1 prefill at the slot capacity: the
        logits of its last position and its cache.  The prompt's upload
        waits for the card under ``scheduler.sync``; the prefill runs under
        ``model.prefill``.  Padded (``ModelApi.prefill_pads``): the prompt
        goes into the static token buffer, the rest of its bucket is zeroed
        and n is set by a fill on the card (no host wait), then the
        bucket's graph replays (its outputs are the graph's own tensors,
        valid until the next replay of any bucket) or, without graphs, the
        same padded prefill runs eagerly.  A replay records no
        ``model.prefill.attn`` or ``.ffn`` span: ``model.prefill`` times
        the input writes and the replay's launch."""
        tokens = np.asarray(req.prompt, np.int64).reshape(1, -1)
        if not self.model.prefill_pads:
            with span("scheduler.sync"):
                prompt = torch.as_tensor(tokens, device=self.device)
                batch = {"tokens": prompt,
                         **extra_tensors(req.extra, self.device)}
            with span("model.prefill"):
                return self.model.prefill(self.params, batch,
                                          self.slot_capacity)
        S, F = tokens.shape[1], self._frontend
        bucket = prefill_bucket(S + F, self._buckets)
        with span("scheduler.sync"):
            self._pf_tokens[:, :S].copy_(torch.from_numpy(tokens))
            # the family's frontend rows (``run`` has checked that they are
            # there); any other input is ignored, as the unpadded prefill does
            extra = extra_tensors(req.extra, self.device)
            for key, rows in self._pf_extra.items():
                rows.copy_(extra[key])
        with span("model.prefill"):
            self._pf_tokens[:, S:bucket - F].zero_()
            self._pf_n.fill_(S + F)
            if not self._prefill_graphs:
                return self._prefill_at(bucket)
            graph, out = self._prefill_graphs[bucket]
            graph.replay()
            self.prefill_replays += 1
            return out

    def _admit(self, req: Request, step_idx: int, row: int) -> None:
        """Admit ``req`` to the first vacant slot: its prefill
        (:meth:`_prefill`, from a graph of its bucket where the scheduler
        graphs and the family pads), its K and V paged into the pool, its
        slot-resident state, first token, block table and the active mask
        written in place."""
        with span("scheduler.admit"):
            slot = int(np.flatnonzero(~self._active)[0])
            logits, cache = self._prefill(req)
            need = self._need(req)
            n_blocks = (self.layout.blocks_for(need)
                        if self.pool.table_width else 0)
            paged, _ = split_cache(cache, self.seq_axes)
            table = self.pool.admit(paged, need)     # may raise PoolExhausted
            self._tables[slot] = table

            def write(ax, st, leaf):
                if ax is None:
                    dst = st[slot] if leaf.dim() == 0 else st[:, slot]
                    dst.copy_(leaf if leaf.dim() == 0 else leaf[:, 0])

            tree_map(write, self.seq_axes, self._state, cache)
            self._tokens[slot].copy_(logits[0, -1:].argmax(dim=-1))
            self._active[slot] = True
            self._upload()
            self._slots[slot] = _Slot(request=req, slot=slot, table=table,
                                      n_blocks=n_blocks,
                                      first=row, admitted_step=step_idx)

    def _can_admit(self, req: Request) -> bool:
        if self._active.all():
            return False
        return (self.layout.blocks_for(self._need(req))
                <= self.pool.allocator.free_blocks)

    def _retire(self, slot: int) -> None:
        with span("scheduler.retire"):
            st = self._slots[slot]
            self.pool.retire(st.table, st.n_blocks)
            self._active[slot] = False
            self._upload()
            self._slots[slot] = None
            # Park the vacant slot at length 0.  Its (discarded) work grows
            # the length a step at a time, and every index it reaches is
            # clipped: the K/V write and the chunk it reads back to the
            # capacity, its page to the sink, its cache_len by the kernel.
            # A Python number written into the card's tensor is a copy
            # that waits for the card.
            with span("scheduler.sync"):
                self._state["length"][slot] = 0

    # ------------------------------------------------------------------ #

    def run(self, requests: Sequence[Request],
            around_step: Optional[Callable[[Callable[[], None]], None]] = None
            ) -> List[RequestResult]:
        """Serve the whole stream; returns results ordered by completion.
        A stream that has not drained within its step budget (every token
        and arrival, plus slack) raises, and so, before any admission, does
        a request without the frontend input its family's prefill takes
        (vlm's ``extra_embeds``, encdec's ``frames``).  ``around_step``,
        where given, is called once a decode step with the step's launch,
        which it must call once: a caller that times or profiles single
        steps wraps it."""
        queue = sorted(requests, key=lambda r: (r.arrival, r.rid))
        frontend = FRONTEND_INPUTS.get(self.model.cfg.family)
        for r in queue:
            if frontend is not None and frontend not in (r.extra or {}):
                raise ValueError(
                    f"request {r.rid} has no {frontend!r}: the "
                    f"{self.model.cfg.family} family's prefill takes it")
            if self._need(r) > self.slot_capacity:
                raise ValueError(
                    f"request {r.rid} needs capacity {self._need(r)} > "
                    f"slot_capacity {self.slot_capacity}; raise "
                    f"max_request_len")
        budget = (sum(r.max_new_tokens for r in queue) + len(queue)
                  + max((r.arrival for r in queue), default=0) + 8)
        # row k: every slot's input token of the stream's k-th decode step
        log = torch.zeros((budget + 1, self.num_slots), dtype=torch.long,
                          device=self.device)
        done: List[tuple] = []      # (slot record, final logits, finish step)
        step_idx = row = 0
        while queue or self._active.any():
            if step_idx > budget:
                raise RuntimeError(
                    f"scheduler exceeded {budget} steps "
                    f"({len(done)}/{len(queue) + len(done)} done)")
            # FIFO admission of every arrived request that fits right now.
            while queue and queue[0].arrival <= step_idx \
                    and self._can_admit(queue[0]):
                self._admit(queue.pop(0), step_idx, row)
            if not self._active.any():
                step_idx += 1           # idle tick: waiting on a future arrival
                continue
            log[row].copy_(self._tokens[:, 0])
            if around_step is None:
                self._launch_step()
            else:
                around_step(self._launch_step)
            self.steps_run += 1
            self.gather_steps += self._gathers
            for slot, st in enumerate(self._slots):
                if st is None:
                    continue
                st.emitted += 1
                self.tokens_emitted += 1
                if st.emitted == st.request.max_new_tokens:
                    done.append((st, self._logits[slot].clone(), step_idx))
                    self._retire(slot)
            row += 1
            step_idx += 1
        if not done:
            return []
        tokens = log[:row].cpu().numpy()
        finals = torch.stack([d[1] for d in done]).cpu().numpy()
        return [RequestResult(
            rid=st.request.rid,
            tokens=tokens[st.first:st.first + st.emitted, st.slot]
            .astype(np.int32),
            final_logits=finals[i],
            prompt_len=int(np.asarray(st.request.prompt).reshape(-1).shape[0]),
            admitted_step=st.admitted_step,
            finished_step=fin,
        ) for i, (st, _, fin) in enumerate(done)]
