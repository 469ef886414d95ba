"""FSI — Fully Serverless Inference (paper Algorithms 1 & 2).

This module contains the exact per-layer logic both channels share:

* offline artifact preparation (the paper's "reads its share of the model
  weights, inference data and per-layer send and receive maps"),
* Algorithm 1 (FSD-Inf-Queue): pack → publish batches → local MVP overlap →
  long-poll → deserialize → accumulate → activation,
* Algorithm 2 (FSD-Inf-Object): per-target single object (or `.nul`) → local
  MVP overlap → LIST/GET loop → accumulate → activation,
* the Serial variant (whole model on one worker, no channel).

The math is executed for real (numpy), byte streams are really compressed
and size-capped, and the clock/billing charges follow the algorithm order —
including the compute/communication overlap the paper exploits (local MVP is
charged *between* the sends and the receives).

Two host execution modes drive the same algorithm:

* the **per-worker** functions (``fsi_queue_send_and_local`` /
  ``fsi_queue_recv`` and the object twins) run one simulated Lambda each;
* the ``*_fleet`` variants batch the host-side hot path across all P
  workers of a layer — one ``pack_rows_fleet`` call packs every worker's
  outgoing row-sets, and the fleet drain decodes every pending chunk and
  lands them with ONE vectorized scatter into a flat fleet buffer
  (:class:`FleetRecvBuffers`).

Both modes share the publish/drain helpers, so billed units, message
counts, and per-worker clock charges are bit-identical by construction
(asserted in ``tests/test_fleet_channels.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Literal, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.backends import ComputeBackend, get_backend
from repro_torch.core.partitioner import PartitionResult
from repro_torch.core.send_recv import LayerCommPlan
from repro_torch.core.sparse import CSRMatrix
from repro_torch.data.graphchallenge import GraphChallengeNet
from repro_torch.faas.object_service import ObjectFabric
from repro_torch.faas.payload import Chunk, decode_chunk, pack_rows_fleet
from repro_torch.faas.queue_service import QueueFabric
from repro_torch.faas.worker import ComputeModel, WorkerState, estimate_worker_memory_bytes

__all__ = [
    "WorkerLayerArtifact",
    "WorkerArtifacts",
    "FleetRecvBuffers",
    "prepare_worker_artifacts",
    "fsi_queue_send_and_local",
    "fsi_queue_send_and_local_fleet",
    "fsi_queue_recv",
    "fsi_queue_recv_fleet",
    "fsi_queue_recv_and_finish",
    "fsi_object_send_and_local",
    "fsi_object_send_and_local_fleet",
    "fsi_object_recv",
    "fsi_object_recv_fleet",
    "fsi_object_recv_and_finish",
    "finish_layer",
    "charge_finish",
    "run_serial",
]

Channel = Literal["queue", "object"]


@dataclasses.dataclass
class WorkerLayerArtifact:
    """Worker ``m``'s offline-prepared share of layer ``k``."""

    layer: int
    W_local: CSRMatrix              # rows = owned out rows, cols = positions in needed_rows
    out_rows: np.ndarray            # global x^k row ids produced here (sorted)
    needed_rows: np.ndarray         # global x^{k-1} row ids required (sorted)
    owned_positions: np.ndarray     # positions of locally-owned inputs in needed_rows
    owned_source_positions: np.ndarray  # positions of those rows in the local x^{k-1} panel
    send_global: Dict[int, np.ndarray]   # target → global row ids
    send_positions: Dict[int, np.ndarray]  # target → positions in local x^{k-1} panel
    recv_expect: Dict[int, int]     # source → number of rows expected
    recv_positions: Dict[int, np.ndarray]  # source → positions in needed_rows
    local_flops: float              # 2·nnz over owned-input columns · batch≈ charged pre-recv
    remote_flops: float             # remainder, charged as contributions arrive
    # per-backend offline compute artifacts (e.g. padded BSR operands),
    # lazily populated; keyed by the backend's state_key (name + config, so
    # two differently-configured instances of one backend never share state)
    backend_states: Dict[str, Any] = dataclasses.field(
        default_factory=dict, repr=False
    )

    def state_for(self, backend: ComputeBackend) -> Any:
        key = getattr(backend, "state_key", backend.name)
        state = self.backend_states.get(key)
        if state is None:
            state = self.backend_states[key] = backend.prepare(self.W_local)
        return state


@dataclasses.dataclass
class WorkerArtifacts:
    rank: int
    layers: List[WorkerLayerArtifact]
    x0_rows: np.ndarray             # global input rows owned (sorted)
    weight_nnz: int
    max_needed: int
    max_out: int

    def memory_bytes(self, batch: int) -> int:
        return estimate_worker_memory_bytes(
            self.weight_nnz, self.max_needed, self.max_out, batch
        )


def prepare_worker_artifacts(
    layers: Sequence[CSRMatrix],
    partition: PartitionResult,
    plans: Sequence[LayerCommPlan],
    backend: Union[str, ComputeBackend, None] = None,
) -> List[WorkerArtifacts]:
    """Offline post-processing of the trained model (paper: hypergraph
    partitioning and map construction happen a priori, not per request).

    When ``backend`` is given, its per-worker-layer compute artifacts (e.g.
    the torch-bsr backend's padded BSR operands) are prepared here too — this is
    offline work, so it is never billed to a worker clock.
    """
    backend = get_backend(backend) if backend is not None else None
    P = partition.P
    out: List[WorkerArtifacts] = []
    for m in range(P):
        arts: List[WorkerLayerArtifact] = []
        weight_nnz = 0
        max_needed = max_out = 0
        prev_owned = np.nonzero(partition.parts[0] == m)[0]
        for k, W in enumerate(layers):
            wp = plans[k].workers[m]
            needed = wp.needed_rows
            out_rows = wp.owned_out_rows
            W_rows = W.select_rows(out_rows)
            # remap columns into the compact needed-space
            col_pos = np.searchsorted(needed, W_rows.indices)
            if needed.size:
                ok = (col_pos < needed.size) & (needed[np.minimum(col_pos, needed.size - 1)] == W_rows.indices)
                if not np.all(ok):
                    raise AssertionError("needed_rows misses a referenced column")
            W_local = CSRMatrix(
                shape=(len(out_rows), len(needed)),
                indptr=W_rows.indptr,
                indices=col_pos.astype(np.int32),
                data=W_rows.data,
            )
            # both operands are sorted-unique global row id sets
            owned_in = np.intersect1d(prev_owned, needed, assume_unique=True)
            owned_positions = np.searchsorted(needed, owned_in)
            owned_source_positions = np.searchsorted(prev_owned, owned_in)
            send_positions = {
                t: np.searchsorted(prev_owned, rows) for t, rows in wp.send.items()
            }
            recv_positions = {
                s: np.searchsorted(needed, rows) for s, rows in wp.recv.items()
            }
            # flops split for the overlap charging
            nnz_per_col = np.bincount(W_local.indices, minlength=len(needed))
            local_nnz = int(nnz_per_col[owned_positions].sum()) if len(needed) else 0
            arts.append(
                art := WorkerLayerArtifact(
                    layer=k,
                    W_local=W_local,
                    out_rows=out_rows,
                    needed_rows=needed,
                    owned_positions=owned_positions,
                    owned_source_positions=owned_source_positions,
                    send_global=dict(wp.send),
                    send_positions=send_positions,
                    recv_expect={s: len(r) for s, r in wp.recv.items()},
                    recv_positions=recv_positions,
                    local_flops=2.0 * local_nnz,
                    remote_flops=2.0 * (W_local.nnz - local_nnz),
                )
            )
            if backend is not None:
                art.state_for(backend)
            weight_nnz += W_local.nnz
            max_needed = max(max_needed, len(needed))
            max_out = max(max_out, len(out_rows))
            prev_owned = out_rows
        out.append(
            WorkerArtifacts(
                rank=m, layers=arts, x0_rows=np.nonzero(partition.parts[0] == m)[0],
                weight_nnz=weight_nnz, max_needed=max_needed, max_out=max_out,
            )
        )
    return out


# ---------------------------------------------------------------------------
# shared send/recv building blocks (per-worker and fleet modes)
# ---------------------------------------------------------------------------


def _empty_marker(layer: int, src: int, batch: int) -> Chunk:
    from repro_torch.faas.payload import encode_chunk

    blob = encode_chunk(
        layer, src, np.zeros(0, np.int32), np.zeros((0, batch), np.float32), 0, 1
    )
    return Chunk(blob, raw_bytes=24)


def _send_jobs(
    art: WorkerLayerArtifact, x_prev: np.ndarray, rank: int,
    exploit_sparsity: bool,
) -> Tuple[List[tuple], List[int]]:
    """Per-target ``(layer, src, rows, vals)`` pack jobs for one worker.

    Activation-sparsity exploitation (paper §III-C2): rows of x^{k-1} that
    are entirely zero carry no information — the receive buffer is
    zero-initialized — so they are dropped from the payload.  The keep mask
    is computed ONCE over the worker's whole panel and gathered per target:
    one panel pass instead of |targets| sliced scans.
    """
    targets = sorted(art.send_global)
    if not targets:
        return [], []
    keep_mask = np.any(x_prev != 0.0, axis=1) if exploit_sparsity else None
    jobs: List[tuple] = []
    for target in targets:
        rows = art.send_global[target]
        posn = art.send_positions[target]
        if keep_mask is None:
            vals = x_prev[posn]
        else:
            k = keep_mask[posn]
            rows, vals = rows[k], x_prev[posn[k]]
        jobs.append((art.layer, rank, rows, vals))
    return jobs, targets


def _collect_entries(
    art: WorkerLayerArtifact, rank: int, batch: int,
    packed: Sequence[Tuple[int, List[Chunk]]],
) -> Tuple[List[Tuple[int, Chunk]], int]:
    """(target, chunk) publish entries + raw-byte total for one worker; a
    target whose payload packed to nothing still gets the per-source
    completion marker (an empty byte string with total=1 — the paper's
    message-attribute handling of multi-message sends)."""
    entries: List[Tuple[int, Chunk]] = []
    raw_total = 0
    for target, chunks in packed:
        if not chunks:
            chunks = [_empty_marker(art.layer, rank, batch)]
        for c in chunks:
            entries.append((target, c))
            raw_total += c.raw_bytes
    return entries, raw_total


def _charge_pack_event(worker: WorkerState, compute: ComputeModel,
                       raw_total: int) -> None:
    """Pack/serialize event: compute-side on both clock models (the payload
    must exist before any lane can send it)."""
    pack_s = raw_total / compute.pack_bandwidth * worker.slowdown
    worker.charge_seconds(pack_s)
    if worker.ledger is not None:
        worker.ledger.compute(pack_s)


def _batch_publish_entries(
    entries: List[Tuple[int, Chunk]], pricing,
) -> List[List[Tuple[int, Chunk]]]:
    """Greedy batching under the SNS caps (≤10 messages, ≤256KB payload)."""
    batches: List[List[Tuple[int, Chunk]]] = []
    cur: List[Tuple[int, Chunk]] = []
    cur_bytes = 0
    for target, c in entries:
        if cur and (
            len(cur) >= pricing.max_messages_per_publish
            or cur_bytes + len(c) > pricing.max_publish_payload
        ):
            batches.append(cur)
            cur, cur_bytes = [], 0
        cur.append((target, c))
        cur_bytes += len(c)
    if cur:
        batches.append(cur)
    return batches


def _queue_publish_entries(
    entries: List[Tuple[int, Chunk]], worker: WorkerState, fabric: QueueFabric,
    compute: ComputeModel, raw_total: int, send_threads: int,
) -> None:
    """The layer send as two schedulable events: the pack event (compute
    timeline), then one aggregated publish event — ALL of the worker's
    per-peer entries batched under the SNS caps and issued round-robin over
    ``send_threads`` lanes in a single fabric interaction (one publish API
    call per ≤10-message batch, not one per destination peer).

    On the overlapped ledger the publish occupies the channel timeline,
    gated on the pack completion; the subsequent local MVP then runs on the
    compute timeline concurrently with the in-flight lanes."""
    _charge_pack_event(worker, compute, raw_total)
    batches = _batch_publish_entries(entries, fabric.pricing)
    if batches:
        led = worker.ledger
        if led is None:
            lane_time = fabric.publish_batches(
                topic=worker.rank % fabric.n_topics, batches=batches,
                at_time=worker.abs_time, lanes=send_threads,
            )
        else:
            lane_time, led_lanes = fabric.publish_batches(
                topic=worker.rank % fabric.n_topics, batches=batches,
                at_time=worker.abs_time, lanes=send_threads,
                ledger_at=max(led.t_channel, led.t_compute),
            )
            led.t_channel = max(led_lanes)
        worker.messages_sent += sum(len(b) for b in batches)
        worker.bytes_sent += sum(len(c) for b in batches for _, c in b)
        worker.advance_to_abs(max(lane_time))


def _object_put_targets(
    art: WorkerLayerArtifact, rank: int,
    packed: Sequence[Tuple[int, List[Chunk]]], worker: WorkerState,
    fabric: ObjectFabric, compute: ComputeModel, io_threads: int,
) -> None:
    """One object (or 0-byte ``.nul`` marker) per target, round-robin over
    ``io_threads`` connections, then the pack-time charge.

    Event split mirrors the queue path: on the overlapped ledger the pack is
    a compute event and the PUT schedule occupies the channel timeline gated
    on it (phased billing keeps its original charge order — the totals are
    order-independent)."""
    target_blobs = [(t, chunks if chunks else []) for t, chunks in packed]
    raw_total = sum(c.raw_bytes for _, chunks in target_blobs for c in chunks)
    led = worker.ledger
    if led is None:
        lane_time = fabric.put_multiparts(
            art.layer, rank, target_blobs, worker.abs_time, lanes=io_threads
        )
        worker.charge_seconds(raw_total / compute.pack_bandwidth * worker.slowdown)
    else:
        # ledger: pack first (the PUT needs its payload), then the lanes
        pack_s = raw_total / compute.pack_bandwidth * worker.slowdown
        led.compute(pack_s)
        lane_time, led_lanes = fabric.put_multiparts(
            art.layer, rank, target_blobs, worker.abs_time, lanes=io_threads,
            ledger_at=max(led.t_channel, led.t_compute),
        )
        if target_blobs:
            led.t_channel = max(led_lanes)
        worker.charge_seconds(pack_s)
    worker.messages_sent += len(target_blobs)
    worker.bytes_sent += sum(
        len(c) for _, chunks in target_blobs for c in chunks
    )
    if target_blobs:
        worker.advance_to_abs(max(lane_time))


@dataclasses.dataclass
class FleetRecvBuffers:
    """One layer's receive buffers for the whole fleet, backed by a single
    flat panel so the fleet drain lands every decoded chunk with one
    vectorized scatter.  ``views[m]`` aliases worker ``m``'s compact input
    buffer (rows = ``arts[m].needed_rows``)."""

    flat: np.ndarray                 # f32[sum(needed_m), batch]
    offsets: np.ndarray              # i64[P+1] row offsets into flat
    views: List[np.ndarray]

    @classmethod
    def allocate(cls, arts: Sequence[WorkerLayerArtifact], batch: int
                 ) -> "FleetRecvBuffers":
        sizes = np.array([len(a.needed_rows) for a in arts], dtype=np.int64)
        offsets = np.zeros(len(arts) + 1, dtype=np.int64)
        np.cumsum(sizes, out=offsets[1:])
        flat = np.zeros((int(offsets[-1]), batch), dtype=np.float32)
        views = [flat[offsets[m]: offsets[m + 1]] for m in range(len(arts))]
        return cls(flat=flat, offsets=offsets, views=views)


def _fleet_local_overlap(
    arts: Sequence[WorkerLayerArtifact], x_panels: Sequence[np.ndarray],
    workers: Sequence[WorkerState], compute: ComputeModel, batch: int,
) -> FleetRecvBuffers:
    """Line 8 / line 9 for the whole fleet: one allocation + one scatter of
    every worker's locally-owned rows, then the per-worker local-MVP charge."""
    fb = FleetRecvBuffers.allocate(arts, batch)
    pos = [fb.offsets[m] + art.owned_positions
           for m, art in enumerate(arts) if art.owned_positions.size]
    if pos:
        vals = [x_panels[m][art.owned_source_positions]
                for m, art in enumerate(arts) if art.owned_positions.size]
        fb.flat[np.concatenate(pos)] = np.vstack(vals)
    for art, worker in zip(arts, workers):
        worker.charge_compute(art.local_flops * batch, compute)
    return fb


# ---------------------------------------------------------------------------
# Algorithm 1 — FSI with FSD-Inf-Queue
# ---------------------------------------------------------------------------


def fsi_queue_send_and_local(
    art: WorkerLayerArtifact,
    x_prev: np.ndarray,              # local panel of owned x^{k-1} rows
    worker: WorkerState,
    fabric: QueueFabric,
    compute: ComputeModel,
    *,
    send_threads: int = 8,
    exploit_sparsity: bool = True,
) -> np.ndarray:
    """Algorithm 1 lines 3-8 for one worker: publish + overlapped local MVP.

    Returns the partially-filled compact input buffer; the recv half runs
    after every worker has entered its send phase (the real system's workers
    run concurrently — the simulator phases them to stay deterministic).
    """
    batch = x_prev.shape[1] if x_prev.ndim == 2 else 1
    # ---- lines 3-7: extract rows, pack byte strings, publish batches -------
    jobs, targets = _send_jobs(art, x_prev, worker.rank, exploit_sparsity)
    packed = list(zip(targets, pack_rows_fleet(
        jobs, fabric.pricing.max_publish_payload)))
    entries, raw_total = _collect_entries(art, worker.rank, batch, packed)
    _queue_publish_entries(entries, worker, fabric, compute, raw_total,
                           send_threads)

    # ---- line 8: local MVP overlapped with in-flight communication --------
    x_buf = np.zeros((len(art.needed_rows), batch), dtype=np.float32)
    x_buf[art.owned_positions] = x_prev[art.owned_source_positions]
    worker.charge_compute(art.local_flops * batch, compute)
    return x_buf


def fsi_queue_send_and_local_fleet(
    arts: Sequence[WorkerLayerArtifact],
    x_panels: Sequence[np.ndarray],
    workers: Sequence[WorkerState],
    fabric: QueueFabric,
    compute: ComputeModel,
    *,
    send_threads: int = 8,
    exploit_sparsity: bool = True,
) -> FleetRecvBuffers:
    """Algorithm 1 lines 3-8 for the WHOLE fleet: every worker's outgoing
    row-sets are packed in one ``pack_rows_fleet`` call (shared normalization
    + one deflate-state pool), then each worker publishes its own batches in
    rank order — byte streams, publish batching, and clock charges are
    bit-identical to P ``fsi_queue_send_and_local`` calls."""
    batch = x_panels[0].shape[1]
    jobs: List[tuple] = []
    fleet_targets: List[List[int]] = []
    for art, x_prev, worker in zip(arts, x_panels, workers):
        wjobs, targets = _send_jobs(art, x_prev, worker.rank, exploit_sparsity)
        jobs.extend(wjobs)
        fleet_targets.append(targets)
    packed_iter = pack_rows_fleet(jobs, fabric.pricing.max_publish_payload)
    for art, worker, targets in zip(arts, workers, fleet_targets):
        packed = [(t, next(packed_iter)) for t in targets]
        entries, raw_total = _collect_entries(art, worker.rank, batch, packed)
        _queue_publish_entries(entries, worker, fabric, compute, raw_total,
                               send_threads)
    return _fleet_local_overlap(arts, x_panels, workers, compute, batch)


def charge_finish(
    art: WorkerLayerArtifact,
    x_buf: np.ndarray,
    x_out: np.ndarray,
    worker: WorkerState,
    compute: ComputeModel,
) -> np.ndarray:
    """Bill the layer-finish work (remote-contribution MVP + epilogue).

    The charges are derived from the CSR shard (2·nnz FLOPs + 3 ops/output),
    NOT from what the host backend actually executed — billed time is the
    modeled Lambda's, identical across compute backends by construction.
    """
    batch = x_buf.shape[1]
    if worker.ledger is not None:
        # dependency edge: the remote-contribution MVP needs the drain done
        worker.ledger.join_compute()
    worker.charge_compute(art.remote_flops * batch, compute)
    worker.charge_compute(3.0 * x_out.size, compute)
    worker.touch_memory((x_buf.nbytes + x_out.nbytes) + art.W_local.nnz * 8)
    return x_out.astype(np.float32, copy=False)


def finish_layer(
    art: WorkerLayerArtifact,
    x_buf: np.ndarray,
    worker: WorkerState,
    compute: ComputeModel,
    bias: float,
    backend: Union[str, ComputeBackend, None] = None,
) -> np.ndarray:
    """Lines 16-18 / 21-23: accumulate contributions + fused activation."""
    backend = get_backend(backend)
    x_out = backend.apply(art.state_for(backend), x_buf, bias)
    return charge_finish(art, x_buf, x_out, worker, compute)


def _queue_drain_one(
    art: WorkerLayerArtifact,
    worker: WorkerState,
    fabric: QueueFabric,
    compute: ComputeModel,
    emit: Callable[[np.ndarray, np.ndarray], None],
    *,
    receipts_out: Optional[List[int]] = None,
) -> None:
    """Algorithm 1 lines 9-15 for one worker: long-poll until every source
    completes, handing each fresh chunk's (buffer positions, value view) to
    ``emit``.  The per-worker and fleet drains share this loop, so the
    (src, seq) dedupe and stale-layer handling cannot diverge.

    ``receipts_out`` defers the receipt deletes: instead of a
    DeleteMessageBatch per poll iteration, receipts are appended to the
    given list and the caller commits (or abandons — the crash-injection
    path) them after the drain.  This is how a ``drain``-phase crash leaves
    its messages in flight to redeliver after the visibility timeout."""
    # Completion is per-source via the 'total byte strings' message attribute
    # (paper: "we cater for the case where source P_n needs to send multiple
    # messages ... using message attributes"), since activation sparsity
    # makes the delivered row count data-dependent.
    pending = set(art.recv_expect)  # sources that will definitely send
    seen_chunks: set[tuple[int, int]] = set()  # (src, seq) — dedupe redeliveries
    got_chunks: Dict[int, int] = {}
    while pending:
        now, deliveries = fabric.poll(worker.rank, worker.abs_time, long_poll=True)
        worker.advance_to_abs(now)
        receipts = []
        for d in deliveries:
            layer, src, rows, vals, seq, total = decode_chunk(bytes(d.blob))
            unpack_s = len(d.blob) / compute.unpack_bandwidth * worker.slowdown
            worker.charge_seconds(unpack_s)
            if worker.ledger is not None:
                # receiver thread: the chunk is in hand at its service-side
                # availability on the sender's ledger; only the decode cost
                # occupies the channel timeline (deletes are fire-and-forget
                # trailing work, off the critical path).  Under eager polling
                # the receive gates on the eager stamp (the poll was already
                # parked when the publish landed).
                avail = worker.ledger.recv_available(
                    d.ledger_at if d.ledger_at is not None else d.deliver_at,
                    d.ledger_eager_at)
                worker.ledger.receive(avail, unpack_s)
            worker.messages_received += 1
            worker.bytes_received += len(d.blob)
            receipts.append(d.receipt)
            if layer != art.layer:
                if layer < art.layer:
                    # stale redelivery of an already-completed layer's chunk
                    # (at-least-once): retire the receipt, touch nothing
                    continue
                raise AssertionError("cross-layer message leakage")
            # SQS is at-least-once: the same (src, seq) chunk may be
            # redelivered.  Writes are idempotent (row-addressed assignment),
            # but completion counting must not be — a duplicate counted
            # toward ``total`` would retire the source before its remaining
            # chunks arrive.
            if (src, seq) in seen_chunks:
                continue
            seen_chunks.add((src, seq))
            if rows.size:
                emit(np.searchsorted(art.needed_rows, rows), vals)
            got_chunks[src] = got_chunks.get(src, 0) + 1
            if src in pending and got_chunks[src] >= total:
                pending.discard(src)
        if receipts_out is not None:
            receipts_out.extend(receipts)
        elif receipts:
            worker.advance_to_abs(fabric.delete_batch(worker.rank, receipts, worker.abs_time))


def fsi_queue_recv(
    art: WorkerLayerArtifact,
    x_buf: np.ndarray,
    worker: WorkerState,
    fabric: QueueFabric,
    compute: ComputeModel,
    *,
    receipts_out: Optional[List[int]] = None,
) -> np.ndarray:
    """Algorithm 1 lines 9-15 for one worker: long-poll until the buffer is
    complete (compute deferred — see ``finish_layer``)."""
    def emit(pos: np.ndarray, vals: np.ndarray) -> None:
        x_buf[pos] = vals            # the one copy of the zero-copy views

    _queue_drain_one(art, worker, fabric, compute, emit,
                     receipts_out=receipts_out)
    return x_buf


def fsi_queue_recv_fleet(
    arts: Sequence[WorkerLayerArtifact],
    bufs: FleetRecvBuffers,
    workers: Sequence[WorkerState],
    fabric: QueueFabric,
    compute: ComputeModel,
) -> List[np.ndarray]:
    """Fleet drain (Algorithm 1 lines 9-15 × P): every worker's queue is
    drained with the shared dedupe loop, but decoded chunks are accumulated
    as (global position, value view) pairs and land in ONE vectorized
    scatter into the flat fleet buffer — the single copy the zero-copy
    ``decode_chunk`` views ever see."""
    pos_parts: List[np.ndarray] = []
    val_parts: List[np.ndarray] = []
    for m, (art, worker) in enumerate(zip(arts, workers)):
        off = int(bufs.offsets[m])

        def emit(pos: np.ndarray, vals: np.ndarray, _off=off) -> None:
            pos_parts.append(_off + pos)
            val_parts.append(vals)

        _queue_drain_one(art, worker, fabric, compute, emit)
    if pos_parts:
        # positions are unique fleet-wide: workers' buffers are disjoint
        # slices, sources own disjoint row sets, and (src, seq) dedupe keeps
        # each chunk once — so one fancy-index assignment is exact.
        bufs.flat[np.concatenate(pos_parts)] = np.vstack(val_parts)
    return bufs.views


def fsi_queue_recv_and_finish(
    art: WorkerLayerArtifact,
    x_buf: np.ndarray,
    worker: WorkerState,
    fabric: QueueFabric,
    compute: ComputeModel,
    bias: float,
    backend: Union[str, ComputeBackend, None] = None,
) -> np.ndarray:
    """Algorithm 1 lines 9-18 for one worker: poll, accumulate, activate."""
    x_buf = fsi_queue_recv(art, x_buf, worker, fabric, compute)
    # ---- lines 16-18: accumulate contributions + activation ---------------
    return finish_layer(art, x_buf, worker, compute, bias, backend)


# ---------------------------------------------------------------------------
# Algorithm 2 — FSI with FSD-Inf-Object
# ---------------------------------------------------------------------------


def fsi_object_send_and_local(
    art: WorkerLayerArtifact,
    x_prev: np.ndarray,
    worker: WorkerState,
    fabric: ObjectFabric,
    compute: ComputeModel,
    *,
    io_threads: int = 8,
    max_object_part: int = 8 * 1024 * 1024,
    exploit_sparsity: bool = True,
) -> np.ndarray:
    """Algorithm 2 lines 3-9 for one worker: non-blocking PUTs + local MVP."""
    batch = x_prev.shape[1] if x_prev.ndim == 2 else 1
    # ---- lines 3-8: one object (or .nul) per target ------------------------
    # Empty payloads (all mapped rows zero under activation sparsity) become
    # 0-byte `.nul` markers, which readers retire without a GET (lines 4-5).
    jobs, targets = _send_jobs(art, x_prev, worker.rank, exploit_sparsity)
    packed = list(zip(targets, pack_rows_fleet(jobs, max_object_part)))
    _object_put_targets(art, worker.rank, packed, worker, fabric, compute,
                        io_threads)

    # ---- line 9: local MVP overlap -----------------------------------------
    x_buf = np.zeros((len(art.needed_rows), batch), dtype=np.float32)
    x_buf[art.owned_positions] = x_prev[art.owned_source_positions]
    worker.charge_compute(art.local_flops * batch, compute)
    return x_buf


def fsi_object_send_and_local_fleet(
    arts: Sequence[WorkerLayerArtifact],
    x_panels: Sequence[np.ndarray],
    workers: Sequence[WorkerState],
    fabric: ObjectFabric,
    compute: ComputeModel,
    *,
    io_threads: int = 8,
    max_object_part: int = 8 * 1024 * 1024,
    exploit_sparsity: bool = True,
) -> FleetRecvBuffers:
    """Algorithm 2 lines 3-9 for the whole fleet: one batched pack, then each
    worker's PUTs in rank order — billing-identical to the per-worker path."""
    batch = x_panels[0].shape[1]
    jobs: List[tuple] = []
    fleet_targets: List[List[int]] = []
    for art, x_prev, worker in zip(arts, x_panels, workers):
        wjobs, targets = _send_jobs(art, x_prev, worker.rank, exploit_sparsity)
        jobs.extend(wjobs)
        fleet_targets.append(targets)
    packed_iter = pack_rows_fleet(jobs, max_object_part)
    for art, worker, targets in zip(arts, workers, fleet_targets):
        packed = [(t, next(packed_iter)) for t in targets]
        _object_put_targets(art, worker.rank, packed, worker, fabric, compute,
                            io_threads)
    return _fleet_local_overlap(arts, x_panels, workers, compute, batch)


def _object_drain_one(
    art: WorkerLayerArtifact,
    worker: WorkerState,
    fabric: ObjectFabric,
    compute: ComputeModel,
    emit: Callable[[np.ndarray, np.ndarray], None],
) -> None:
    """Algorithm 2 lines 10-20 for one worker: LIST/GET until the recv map is
    satisfied, handing each part's (positions, value view) to ``emit``."""
    expect = dict(art.recv_expect)
    seen: set[str] = set()
    while expect:
        now, handles = fabric.list_files(art.layer, worker.rank, worker.abs_time)
        worker.advance_to_abs(now)
        progress = False
        for h in handles:
            if h.key in seen:
                continue
            if h.src not in expect:
                continue  # line 16: already received / not awaited — no GET
            seen.add(h.key)
            led_avail = (h.ledger_visible_at if h.ledger_visible_at is not None
                         else h.visible_at)
            if worker.ledger is not None:
                led_avail = worker.ledger.recv_available(
                    led_avail, h.ledger_eager_visible_at)
            if h.is_nul:
                if worker.ledger is not None:
                    # the reader must still observe the marker appear
                    worker.ledger.receive(led_avail, 0.0)
                del expect[h.src]  # line 13-14: retire source, never read
                progress = True
                continue
            now, blob = fabric.get_obj(art.layer, worker.rank, h.key, worker.abs_time)
            worker.advance_to_abs(now)
            unpack_s = len(blob) / compute.unpack_bandwidth * worker.slowdown
            worker.charge_seconds(unpack_s)
            if worker.ledger is not None:
                # reader thread: GET stream + decode, gated on the object's
                # ledger visibility (LIST polling is folded into the blocked
                # reader loop, like the queue path's long poll)
                worker.ledger.receive(
                    led_avail,
                    fabric.get_first_byte + h.size / fabric.bandwidth + unpack_s,
                )
            worker.messages_received += 1
            worker.bytes_received += len(blob)
            for part in ObjectFabric.split_multipart(bytes(blob)):
                layer, src, rows, vals, _, _ = decode_chunk(part)
                emit(np.searchsorted(art.needed_rows, rows), vals)
            del expect[h.src]
            progress = True
        if expect and not progress:
            # back off one LIST interval before re-scanning the prefix
            worker.charge_seconds(fabric.list_latency)


def fsi_object_recv(
    art: WorkerLayerArtifact,
    x_buf: np.ndarray,
    worker: WorkerState,
    fabric: ObjectFabric,
    compute: ComputeModel,
) -> np.ndarray:
    """Algorithm 2 lines 10-20 for one worker: LIST/GET until the recv map is
    satisfied (compute deferred — see ``finish_layer``)."""
    def emit(pos: np.ndarray, vals: np.ndarray) -> None:
        x_buf[pos] = vals

    _object_drain_one(art, worker, fabric, compute, emit)
    return x_buf


def fsi_object_recv_fleet(
    arts: Sequence[WorkerLayerArtifact],
    bufs: FleetRecvBuffers,
    workers: Sequence[WorkerState],
    fabric: ObjectFabric,
    compute: ComputeModel,
) -> List[np.ndarray]:
    """Fleet drain (Algorithm 2 lines 10-20 × P) with one vectorized scatter
    into the flat fleet buffer — the object twin of ``fsi_queue_recv_fleet``."""
    pos_parts: List[np.ndarray] = []
    val_parts: List[np.ndarray] = []
    for m, (art, worker) in enumerate(zip(arts, workers)):
        off = int(bufs.offsets[m])

        def emit(pos: np.ndarray, vals: np.ndarray, _off=off) -> None:
            pos_parts.append(_off + pos)
            val_parts.append(vals)

        _object_drain_one(art, worker, fabric, compute, emit)
    if pos_parts:
        bufs.flat[np.concatenate(pos_parts)] = np.vstack(val_parts)
    return bufs.views


def fsi_object_recv_and_finish(
    art: WorkerLayerArtifact,
    x_buf: np.ndarray,
    worker: WorkerState,
    fabric: ObjectFabric,
    compute: ComputeModel,
    bias: float,
    backend: Union[str, ComputeBackend, None] = None,
) -> np.ndarray:
    """Algorithm 2 lines 10-23 for one worker: LIST/GET, accumulate, activate."""
    x_buf = fsi_object_recv(art, x_buf, worker, fabric, compute)
    # ---- lines 21-23: accumulate + activation -------------------------------
    return finish_layer(art, x_buf, worker, compute, bias, backend)


# ---------------------------------------------------------------------------
# FSD-Inf-Serial
# ---------------------------------------------------------------------------


def run_serial(
    net: GraphChallengeNet,
    x0: np.ndarray,
    memory_mb: int = 10240,
    compute: ComputeModel | None = None,
    backend: Union[str, ComputeBackend, None] = None,
) -> tuple[np.ndarray, WorkerState]:
    """Single-instance execution (Algorithm 1 with communication removed)."""
    compute = compute or ComputeModel()
    backend = get_backend(backend)
    batch = x0.shape[1]
    need = estimate_worker_memory_bytes(
        net.total_nnz, net.neurons, net.neurons, batch
    )
    if need > memory_mb * 1024 * 1024:
        raise MemoryError(
            f"FSD-Inf-Serial needs ~{need/1e9:.1f}GB > {memory_mb}MB Lambda limit"
        )
    # offline artifact prep (unbilled, like the distributed path's maps)
    states = [backend.prepare(W) for W in net.layers]
    w = WorkerState(rank=0, memory_mb=memory_mb)
    x = x0.astype(np.float32)
    for W, state in zip(net.layers, states):
        x = backend.apply(state, x, net.bias).astype(np.float32, copy=False)
        w.charge_compute(2.0 * W.nnz * batch + 3.0 * x.size, compute)
    w.touch_memory(need)
    return x, w
