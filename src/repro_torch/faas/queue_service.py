"""Simulated SNS (pub-sub) + SQS (queues) fabric — FSD-Inf-Queue (§III-A).

Topology per the paper (Fig. 2):

* ``n_topics`` parallel SNS topics (``topic-{m%10}``) to spread publish load
  and avoid single-resource I/O bottlenecks;
* one *dedicated* SQS queue per worker, subscribed to every topic with a
  service-side **filter policy** on the ``target`` message attribute — the
  fan-out and filtering run in the provider's backend, not on the
  resource-constrained workers;
* publishes are batched (≤10 messages, ≤256KB total) and billed in 64KB
  increments; SQS is billed per API call (receive / delete batches);
* 'long' polling (W>0) visits all queue servers and waits up to W seconds,
  returning as soon as messages exist — 'short' polling (W=0) samples a
  subset of servers and may miss messages (modeled as a per-message visibility
  probability), which is why the paper finds long polling strictly better.

Latency accounting lives with the fabric so both FSI algorithms and the
MPI-style collectives bill through one place.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cost_model import PricingConstants, AWS_PRICING
from repro_torch.faas.payload import Chunk

__all__ = ["QueueFabric", "QueueMetrics", "Delivery"]


@dataclasses.dataclass
class Delivery:
    deliver_at: float        # service-side availability time (seconds)
    target: int
    blob: Chunk
    attributes: Dict[str, int]
    receipt: int = -1
    # Availability under the overlapped-pipeline ledger (sender's channel
    # timeline + fan-out).  None when the sender carried no ledger; drains
    # then fall back to ``deliver_at``.
    ledger_at: Optional[float] = None
    # Availability under an *eager* long-poll: the consumer's ReceiveMessage
    # is already parked on the queue before the sender publishes, so the
    # message reaches the reader after the one-way publish half-trip, the
    # fan-out, and the push half of the poll RTT — the request half was
    # spent while the sender was still packing.  Ledger-only; billing and
    # the phased ``deliver_at`` schedule never read this.
    ledger_eager_at: Optional[float] = None


@dataclasses.dataclass
class QueueMetrics:
    publish_api_calls: int = 0
    publish_billed_units: int = 0       # S in Eq. 5
    bytes_sns_to_sqs: int = 0           # Z in Eq. 5
    sqs_api_calls: int = 0              # Q in Eq. 6
    messages_delivered: int = 0
    empty_polls: int = 0
    raw_bytes: int = 0                  # pre-compression volume (Table III)
    redeliveries: int = 0               # visibility-timeout expiries requeued
    throttle_retries: int = 0           # chaos-injected 429 retries


class QueueFabric:
    """The SNS topics + per-worker SQS queues, with billing counters."""

    def __init__(
        self,
        n_workers: int,
        n_topics: int = 10,
        pricing: PricingConstants = AWS_PRICING,
        publish_latency: float = 0.012,
        fanout_latency: float = 0.020,
        poll_rtt: float = 0.008,
        long_poll_window: float = 2.0,
        short_poll_miss_prob: float = 0.35,
        seed: int = 0,
        visibility_timeout: float = 30.0,
    ):
        self.n_workers = n_workers
        self.n_topics = max(1, min(n_topics, n_workers))
        self.pricing = pricing
        self.publish_latency = publish_latency
        self.fanout_latency = fanout_latency
        self.poll_rtt = poll_rtt
        self.long_poll_window = long_poll_window
        self.short_poll_miss_prob = short_poll_miss_prob
        self.visibility_timeout = visibility_timeout
        self.metrics = QueueMetrics()
        self._queues: List[List[Delivery]] = [[] for _ in range(n_workers)]
        # At-least-once delivery: polled messages move here keyed by receipt
        # until DeleteMessageBatch retires them; past ``visible_again_at`` an
        # undeleted message is requeued (with a fresh receipt) and re-billed
        # on the next poll that reaches it.
        self._inflight: List[Dict[int, Tuple[float, "_OrderedDelivery"]]] = [
            {} for _ in range(n_workers)
        ]
        self._rng = np.random.default_rng(seed)
        self._receipt = 0
        # Optional chaos hook (repro_torch.faas.chaos.ChaosState); when set, publish
        # and poll consult it for 429 throttles and SNS-internal redelivery
        # delays.  None in production runs — zero overhead, zero billing drift.
        self.chaos = None

    # -- producer side ------------------------------------------------------

    def publish_batch(
        self, topic: int, entries: List[Tuple[int, Chunk]], at_time: float,
        *, ledger_at: Optional[float] = None,
    ) -> float:
        """Publish ≤10 (target, blob) entries; returns completion time.

        Billing: one publish request per 64KB increment of the total payload
        (a 256KB batch = 4 billed units).  Data transfer SNS→SQS is billed
        per byte (Z).

        ``ledger_at`` is the send start on the overlapped-pipeline timeline;
        it only stamps each delivery's ``ledger_at`` availability and never
        affects billing or the phased delivery schedule.
        """
        if not (1 <= len(entries) <= self.pricing.max_messages_per_publish):
            raise ValueError("publish batch must contain 1..10 messages")
        payload = sum(len(b) for _, b in entries)
        if payload > self.pricing.max_publish_payload:
            raise ValueError(
                f"publish payload {payload}B exceeds "
                f"{self.pricing.max_publish_payload}B cap"
            )
        extra_fanout = 0.0
        if self.chaos is not None:
            at_time, n_retries = self.chaos.throttle("sns_publish", at_time)
            self.metrics.throttle_retries += n_retries
            extra_fanout = self.chaos.publish_delay()
        self.metrics.publish_api_calls += 1
        self.metrics.publish_billed_units += max(
            1, -(-payload // self.pricing.publish_billing_unit)
        )
        self.metrics.bytes_sns_to_sqs += payload
        self.metrics.raw_bytes += sum(b.raw_bytes for _, b in entries)
        done = at_time + self.publish_latency
        led_avail = (None if ledger_at is None
                     else ledger_at + self.publish_latency + self.fanout_latency
                     + extra_fanout)
        # Eager long-poll availability: the reader's poll is already open, so
        # only the one-way publish half-trip (the ack half overlaps fan-out),
        # the fan-out, and the push half of the poll RTT precede delivery.
        # The sender's lane still occupies the full publish_latency.
        led_eager = (None if ledger_at is None
                     else ledger_at + self.publish_latency / 2
                     + self.fanout_latency + extra_fanout + self.poll_rtt / 2)
        for target, blob in entries:
            if not (0 <= target < self.n_workers):
                raise ValueError(f"bad filter target {target}")
            heapq.heappush(
                self._queues[target],
                # heap keyed by delivery time; receipt id breaks ties
                _OrderedDelivery(
                    done + self.fanout_latency + extra_fanout,
                    self._next_receipt(), target,
                    blob, ledger_at=led_avail, ledger_eager_at=led_eager,
                ),
            )
        return done

    def publish_batches(
        self, topic: int, batches: List[List[Tuple[int, Chunk]]],
        at_time: float, lanes: int = 8,
        *, ledger_at: Optional[float] = None,
    ):
        """Publish a sequence of batches round-robin over ``lanes`` concurrent
        connections starting at ``at_time``; returns the per-lane completion
        times.  Billing is exactly ``len(batches)`` ``publish_batch`` calls —
        this is the one-call entry point the fleet send path uses so a layer's
        whole publish schedule is a single fabric interaction.

        With ``ledger_at`` set, the same lane schedule is mirrored on the
        overlapped timeline starting at ``ledger_at`` (identical assignment
        ``i % lanes``), and the return is ``(lane_time, ledger_lane_time)``.
        """
        lane_time = [at_time] * max(1, lanes)
        led_lanes = None if ledger_at is None else [ledger_at] * len(lane_time)
        for i, batch in enumerate(batches):
            lane = i % len(lane_time)
            if led_lanes is None:
                lane_time[lane] = self.publish_batch(topic, batch, lane_time[lane])
            else:
                lane_time[lane] = self.publish_batch(
                    topic, batch, lane_time[lane], ledger_at=led_lanes[lane]
                )
                led_lanes[lane] += self.publish_latency
        if ledger_at is None:
            return lane_time
        return lane_time, led_lanes

    def _next_receipt(self) -> int:
        self._receipt += 1
        return self._receipt

    # -- consumer side ------------------------------------------------------

    def poll(
        self, worker: int, at_time: float, long_poll: bool = True, max_messages: int = 10
    ) -> Tuple[float, List[Delivery]]:
        """ReceiveMessage.  Returns (time_after_poll, deliveries).

        Long polling: if nothing is available now, block until the earliest
        delivery or the window expiry, whichever first (no extra API cost
        while waiting).  Short polling: returns immediately, and each
        available message is missed with ``short_poll_miss_prob`` (not all
        SQS servers are visited).

        Boundary semantics (pinned): a long poll waits over the half-open
        window ``[now, now + long_poll_window)``.  A message whose
        ``deliver_at`` lands exactly on the window deadline is NOT returned —
        the empty response is already on the wire at that instant — so the
        call bills one empty poll and the next call collects the message.
        Every call counts exactly one of {delivered, empty}, never both.

        At-least-once semantics: returned messages are NOT removed — they
        move to an in-flight set with a ``visibility_timeout`` deadline and
        only ``delete_batch`` retires them.  An undeleted message reappears
        (fresh receipt, re-billed on redelivery) once the deadline passes.
        """
        if self.chaos is not None:
            at_time, n_retries = self.chaos.throttle("sqs_receive", at_time)
            self.metrics.throttle_retries += n_retries
        self.metrics.sqs_api_calls += 1
        q = self._queues[worker]
        now = at_time + self.poll_rtt
        self._requeue_expired(worker, now)
        inflight = self._inflight[worker]

        def available(t: float) -> List[_OrderedDelivery]:
            out = []
            while q and q[0].deliver_at <= t and len(out) < max_messages:
                out.append(heapq.heappop(q))
            return out

        if long_poll:
            got = available(now)
            if not got:
                deadline = now + self.long_poll_window
                # The earliest thing that can show up inside the window is
                # either a scheduled delivery or an in-flight message whose
                # visibility deadline expires (a redelivery).
                wake = q[0].deliver_at if q else float("inf")
                if inflight:
                    wake = min(wake, min(t for t, _ in inflight.values()))
                if wake < deadline:
                    now = max(now, wake)
                    self._requeue_expired(worker, now)
                    got = available(now)
                else:
                    now = deadline
        else:
            got = []
            for d in available(now):
                if self._rng.random() < self.short_poll_miss_prob:
                    heapq.heappush(q, d)  # not seen this poll
                else:
                    got.append(d)
        if got:
            self.metrics.messages_delivered += len(got)
            for d in got:
                inflight[d.receipt] = (now + self.visibility_timeout, d)
        else:
            self.metrics.empty_polls += 1
        return now, [d.as_delivery() for d in got]

    def _requeue_expired(self, worker: int, t: float) -> None:
        """Requeue in-flight messages whose visibility deadline has passed.

        Redelivered messages get a fresh receipt (as SQS receipt handles do),
        so a late delete of the old receipt is a harmless no-op; ledger
        stamps are cleared so drains time the redelivery off ``deliver_at``.
        """
        inflight = self._inflight[worker]
        expired = [r for r, (vis, _) in inflight.items() if vis <= t]
        for r in expired:
            vis, d = inflight.pop(r)
            self.metrics.redeliveries += 1
            heapq.heappush(
                self._queues[worker],
                _OrderedDelivery(vis, self._next_receipt(), d.target, d.blob),
            )

    def delete_batch(self, worker: int, receipts: List[int], at_time: float) -> float:
        """DeleteMessageBatch — one API call per ≤10 receipts.

        An empty receipt list is a no-op: no API call is made (and none
        billed), and no RTT is paid.  Unknown / already-requeued receipts
        within a non-empty batch are ignored, matching SQS's per-entry
        failure semantics.
        """
        if not receipts:
            return at_time
        n_calls = -(-len(receipts) // 10)
        self.metrics.sqs_api_calls += n_calls
        inflight = self._inflight[worker]
        for r in receipts:
            inflight.pop(r, None)
        return at_time + self.poll_rtt

    def pending(self, worker: int) -> int:
        return len(self._queues[worker])


@dataclasses.dataclass(order=True)
class _OrderedDelivery:
    deliver_at: float
    receipt: int
    target: int = dataclasses.field(compare=False)
    blob: Chunk = dataclasses.field(compare=False)
    ledger_at: Optional[float] = dataclasses.field(compare=False, default=None)
    ledger_eager_at: Optional[float] = dataclasses.field(compare=False,
                                                         default=None)

    def as_delivery(self) -> Delivery:
        return Delivery(
            deliver_at=self.deliver_at,
            target=self.target,
            blob=self.blob,
            attributes={},
            receipt=self.receipt,
            ledger_at=self.ledger_at,
            ledger_eager_at=self.ledger_eager_at,
        )
