"""MPI-style collectives over serverless channels (paper §II-B objective 6).

The root worker coordinates Barrier / Reduce / Broadcast / AllReduce through
the same pub-sub or object fabric used for point-to-point exchange, routed
along the launch tree (partial aggregation at internal nodes keeps the root's
queue shallow).  Timing is computed analytically over the tree — equivalent
to simulating the token messages one by one — while API calls and bytes are
billed on the fabric's meters.

Billing comes in two flavours:

* ``aggregate=True`` (default) — FMI-style message aggregation: all of a
  node's per-peer small messages in one sweep step are packed into the
  fewest publish batches the SNS caps allow (≤10 messages / ≤256KB), and a
  receiving node drains its whole step with batched polls + one batched
  delete (object fabric: one LIST per node instead of one per edge).  Per
  sweep step a node issues O(1) API calls instead of O(degree);
* ``aggregate=False`` — the per-edge reference (one publish/PUT + one
  poll/LIST per tree edge), kept so fabric-metrics tests can pin the
  reduction.

``reduce_to_root(..., sync=True)`` additionally fuses the final barrier into
the reduce: the up-sweep payload doubles as the sync token, so no separate
barrier sweeps run — this is what ``run_fsi`` uses for the output gather.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.faas.launch_tree import TreeSpec
from repro_torch.faas.object_service import ObjectFabric
from repro_torch.faas.payload import Chunk
from repro_torch.faas.queue_service import QueueFabric
from repro_torch.faas.worker import WorkerState

__all__ = ["barrier", "reduce_to_root", "broadcast", "all_reduce"]

_TOKEN_BYTES = 64


def _edge_cost(fabric, eager: bool = False) -> float:
    """One-hop message time over the fabric.

    ``eager=True`` gives the ledger-side hop under eager polling: the
    receiver's long-poll / LIST is already parked when the send starts, so
    only the one-way publish half-trip and the push half of the poll RTT
    serialize (queue), or the one-way PUT half-trip before the in-flight
    LIST can observe the object (object).  Phased timing and billing always
    use the blocked-reader cost."""
    if isinstance(fabric, QueueFabric):
        if eager:
            return (fabric.publish_latency / 2 + fabric.fanout_latency
                    + fabric.poll_rtt / 2)
        return fabric.publish_latency + fabric.fanout_latency + fabric.poll_rtt
    if eager:
        return (fabric.put_latency / 2 + fabric.list_latency
                + fabric.get_first_byte)
    return fabric.put_latency + fabric.list_latency + fabric.get_first_byte


def _ledger_edge_cost(fabric, workers: Sequence[WorkerState]) -> float:
    """Edge cost on the ledger timelines: eager iff every ledger-carrying
    worker polls eagerly (the fleet shares one polling policy)."""
    eager = any(w.ledger is not None for w in workers) and all(
        w.ledger.eager_poll for w in workers if w.ledger is not None)
    return _edge_cost(fabric, eager=eager)


def _chunks(data: bytes, cap: int) -> List[Chunk]:
    return [Chunk(data[lo: lo + cap], raw_bytes=len(data[lo: lo + cap]))
            for lo in range(0, len(data), cap)]


def _bill_edge(fabric, layer: int, src: int, dst: int, payload: bytes | None):
    """Per-edge reference billing (``aggregate=False``): one publish per
    chunk per edge, one poll/LIST + delete per edge."""
    data = payload or b"\0" * _TOKEN_BYTES
    if isinstance(fabric, QueueFabric):
        cap = fabric.pricing.max_publish_payload
        for lo in range(0, len(data), cap):
            blob = Chunk(data[lo: lo + cap], raw_bytes=len(data[lo: lo + cap]))
            fabric.publish_batch(src % fabric.n_topics, [(dst, blob)], 0.0)
        n_msgs = -(-len(data) // cap)
        fabric.poll(dst, 1e9, long_poll=True)  # drain for billing
        fabric.delete_batch(dst, list(range(n_msgs)), 0.0)
    else:
        blob = Chunk(data, raw_bytes=len(data))
        fabric.put_obj(layer, src, dst, blob, 0.0)
        now, handles = fabric.list_files(layer, dst, 1e9)
        for h in handles:
            if not h.is_nul:
                fabric.get_obj(layer, dst, h.key, now)
        fabric._store.pop(fabric._prefix(layer, dst), None)


def _bill_sends(fabric, layer: int,
                edges: Sequence[Tuple[int, int, bytes | None]]) -> None:
    """Aggregated sender-side billing for a sweep step: every ``(src, dst,
    payload)`` edge's chunks are packed into the fewest publish batches the
    SNS caps allow, per source (object fabric: one PUT per edge — objects
    are keyed per target, but readers still aggregate on the drain side)."""
    if isinstance(fabric, QueueFabric):
        cap = fabric.pricing.max_publish_payload
        per_msg = fabric.pricing.max_messages_per_publish
        by_src: Dict[int, List[Tuple[int, Chunk]]] = {}
        for src, dst, payload in edges:
            data = payload or b"\0" * _TOKEN_BYTES
            for c in _chunks(data, cap):
                by_src.setdefault(src, []).append((dst, c))
        for src, entries in by_src.items():
            cur: List[Tuple[int, Chunk]] = []
            cur_bytes = 0
            for dst, c in entries:
                if cur and (len(cur) >= per_msg or cur_bytes + len(c) > cap):
                    fabric.publish_batch(src % fabric.n_topics, cur, 0.0)
                    cur, cur_bytes = [], 0
                cur.append((dst, c))
                cur_bytes += len(c)
            if cur:
                fabric.publish_batch(src % fabric.n_topics, cur, 0.0)
    else:
        for src, dst, payload in edges:
            data = payload or b"\0" * _TOKEN_BYTES
            fabric.put_obj(layer, src, dst, Chunk(data, raw_bytes=len(data)), 0.0)


def _bill_drain(fabric, layer: int, dst: int) -> None:
    """Aggregated receiver-side billing: drain everything pending for ``dst``
    with ≤10-message polls and ONE batched delete (queue), or one LIST + the
    GETs (object) — O(1)-ish API calls per node per sweep step."""
    if isinstance(fabric, QueueFabric):
        receipts: List[int] = []
        while fabric.pending(dst):
            _, deliveries = fabric.poll(dst, 1e9, long_poll=True)
            receipts.extend(d.receipt for d in deliveries)
        if receipts:
            fabric.delete_batch(dst, receipts, 0.0)
    else:
        now, handles = fabric.list_files(layer, dst, 1e9)
        for h in handles:
            if not h.is_nul:
                fabric.get_obj(layer, dst, h.key, now)
        fabric._store.pop(fabric._prefix(layer, dst), None)


def barrier(
    workers: Sequence[WorkerState], fabric, tree: TreeSpec,
    layer_tag: int = 1 << 20, *, aggregate: bool = True,
) -> float:
    """Tree up-sweep + down-sweep; on return every worker clock is aligned."""
    P = len(workers)
    edge = _edge_cost(fabric)
    edge_led = _ledger_edge_cost(fabric, workers)
    # up-sweep: completion time at each node (phased and ledger timelines)
    up = [0.0] * P
    up_led = [0.0] * P
    for m in reversed(range(P)):
        t = workers[m].abs_time
        tl = workers[m].overlap_time
        kids = tree.children(m)
        for c in kids:
            t = max(t, up[c] + edge)
            tl = max(tl, up_led[c] + edge_led)
        if kids:
            if aggregate:
                _bill_sends(fabric, layer_tag, [(c, m, None) for c in kids])
                _bill_drain(fabric, layer_tag, m)
            else:
                for c in kids:
                    _bill_edge(fabric, layer_tag, c, m, None)
        up[m] = t
        up_led[m] = tl
    # down-sweep: release times
    release = [0.0] * P
    release_led = [0.0] * P
    release[0] = up[0]
    release_led[0] = up_led[0]
    for m in range(P):
        kids = tree.children(m)
        if kids:
            if aggregate:
                _bill_sends(fabric, layer_tag, [(m, c, None) for c in kids])
                for c in kids:
                    _bill_drain(fabric, layer_tag, c)
            else:
                for c in kids:
                    _bill_edge(fabric, layer_tag, m, c, None)
        for c in kids:
            release[c] = release[m] + edge
            release_led[c] = release_led[m] + edge_led
    for m, w in enumerate(workers):
        w.advance_to_abs(release[m])
        if w.ledger is not None:
            w.ledger.sync_to(release_led[m])
    return max(release)


def reduce_to_root(
    workers: Sequence[WorkerState],
    fabric,
    tree: TreeSpec,
    payloads: List[np.ndarray],
    op: str = "concat_rows",
    layer_tag: int = 1 << 21,
    *,
    aggregate: bool = True,
    sync: bool = False,
) -> np.ndarray:
    """Reduce(P_0, ·): partial aggregation at internal nodes (paper line 20/25).

    ``op='concat_rows'`` stacks row panels **in worker-rank order** (the FSI
    output gather — callers unpermute against rank-ordered row ids, so the
    root re-sorts the panels it aggregated in tree-traversal order; with
    branching b, ranks ≥ b+2 otherwise arrive interleaved under their parent
    subtree and the gather would be silently misassembled);
    ``op='sum'`` adds equal-shaped arrays (classic MPI_Reduce).

    With ``sync=True`` the reduce doubles as the final barrier (FMI-style
    collective fusion): the up-sweep payload IS the sync token, every worker
    is advanced to the time its aggregated subtree panel is handed to its
    parent, and no separate barrier sweeps run.
    """
    P = len(workers)
    edge = _edge_cost(fabric)
    edge_led = _ledger_edge_cost(fabric, workers)
    bw = _bandwidth(fabric)
    # accumulate (rank, panel) pairs so the root can restore rank order no
    # matter how the tree interleaved the subtrees
    acc: List[List[tuple]] = [[(m, payloads[m])] for m in range(P)]
    done = [0.0] * P
    done_led = [0.0] * P
    for m in reversed(range(P)):
        t = workers[m].abs_time
        tl = workers[m].overlap_time
        step_edges: List[Tuple[int, int, bytes | None]] = []
        for c in tree.children(m):
            blob = b"".join(np.ascontiguousarray(a).tobytes()
                            for _, a in acc[c])
            t = max(t, done[c] + edge + len(blob) / bw)
            tl = max(tl, done_led[c] + edge_led + len(blob) / bw)
            step_edges.append((c, m, blob))
            acc[m].extend(acc[c])
        if step_edges:
            if aggregate:
                _bill_sends(fabric, layer_tag, step_edges)
                _bill_drain(fabric, layer_tag, m)
            else:
                for c, _, blob in step_edges:
                    _bill_edge(fabric, layer_tag, c, m, blob)
        done[m] = t
        done_led[m] = tl
    if sync:
        # a non-root worker finishes once its panel is handed up the tree
        for m, w in enumerate(workers):
            hop = edge if m != 0 else 0.0
            hop_led = edge_led if m != 0 else 0.0
            w.advance_to_abs(done[m] + hop)
            if w.ledger is not None:
                w.ledger.sync_to(done_led[m] + hop_led)
    else:
        workers[0].advance_to_abs(done[0])
        if workers[0].ledger is not None:
            workers[0].ledger.sync_to(done_led[0])
    if op == "sum":
        out = acc[0][0][1].copy()
        for _, a in acc[0][1:]:
            out = out + a
        return out
    return np.concatenate(
        [a for _, a in sorted(acc[0], key=lambda pair: pair[0])], axis=0
    )


def broadcast(
    workers: Sequence[WorkerState], fabric, tree: TreeSpec, payload: np.ndarray,
    layer_tag: int = 1 << 22, *, aggregate: bool = True,
) -> None:
    P = len(workers)
    edge = _edge_cost(fabric)
    edge_led = _ledger_edge_cost(fabric, workers)
    blob = np.ascontiguousarray(payload).tobytes()
    t = [0.0] * P
    t_led = [0.0] * P
    t[0] = workers[0].abs_time
    t_led[0] = workers[0].overlap_time
    for m in range(P):
        kids = tree.children(m)
        if kids:
            if aggregate:
                _bill_sends(fabric, layer_tag, [(m, c, blob) for c in kids])
                for c in kids:
                    _bill_drain(fabric, layer_tag, c)
            else:
                for c in kids:
                    _bill_edge(fabric, layer_tag, m, c, blob)
        for c in kids:
            t[c] = t[m] + edge + len(blob) / _bandwidth(fabric)
            t_led[c] = t_led[m] + edge_led + len(blob) / _bandwidth(fabric)
    for m, w in enumerate(workers):
        w.advance_to_abs(t[m])
        if w.ledger is not None:
            w.ledger.sync_to(t_led[m])


def all_reduce(
    workers: Sequence[WorkerState], fabric, tree: TreeSpec, payloads: List[np.ndarray]
) -> np.ndarray:
    out = reduce_to_root(workers, fabric, tree, payloads, op="sum")
    broadcast(workers, fabric, tree, out)
    return out


def _bandwidth(fabric) -> float:
    if isinstance(fabric, ObjectFabric):
        return fabric.bandwidth
    return 60e6  # effective SNS/SQS per-connection throughput
