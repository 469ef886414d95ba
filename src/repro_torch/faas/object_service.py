"""Simulated S3 object storage fabric — FSD-Inf-Object (paper §III-B).

Per the paper (Fig. 3):

* ``n_buckets`` containers (``bucket-{n%10}``) so the per-prefix API request
  quota scales k-fold [Lambada];
* worker ``m`` sending to worker ``n`` in layer ``k`` writes
  ``bucket-{n%b}/{k}/{n}/{m}_{n}.dat`` — or a zero-byte ``.nul`` marker when
  it has nothing to send, so readers never GET empty files;
* readers repeatedly LIST their own single prefix ``bucket-{m%b}/{k}/{m}/``
  and GET only ``.dat`` handles still present in their recv map;
* PUT/GET/LIST are billed per request, *independent of object size*, and
  data transfer S3↔Lambda is free in-region — which is exactly why Object
  wins at very large payloads and loses at high parallelism (§IV-C).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.faas.payload import Chunk

__all__ = ["ObjectFabric", "ObjectMetrics", "ObjectHandle"]


@dataclasses.dataclass
class ObjectMetrics:
    puts: int = 0       # V in Eq. 7
    gets: int = 0       # R in Eq. 7
    lists: int = 0      # L in Eq. 7
    bytes_written: int = 0
    raw_bytes: int = 0
    nul_files: int = 0
    throttle_retries: int = 0   # chaos-injected 503/429 retries


@dataclasses.dataclass
class ObjectHandle:
    key: str
    size: int
    visible_at: float
    is_nul: bool
    src: int
    # Visibility under the overlapped-pipeline ledger (sender's channel
    # timeline + PUT latency + streaming).  None when the writer carried no
    # ledger; drains then fall back to ``visible_at``.
    ledger_visible_at: Optional[float] = None
    # Visibility under an *eager* reader: its LIST loop is already running
    # when the PUT lands, so the object becomes actionable after the one-way
    # PUT half-trip plus streaming — the PUT ack half overlaps the reader's
    # in-flight LIST.  The reader still pays its own LIST + GET latencies on
    # receive.  Ledger-only; billing and phased visibility never read this.
    ledger_eager_visible_at: Optional[float] = None


class ObjectFabric:
    def __init__(
        self,
        n_workers: int,
        n_buckets: int = 10,
        put_latency: float = 0.030,
        get_first_byte: float = 0.018,
        list_latency: float = 0.025,
        bandwidth: float = 90e6,  # per-connection S3 streaming throughput
    ):
        self.n_workers = n_workers
        self.n_buckets = max(1, min(n_buckets, n_workers))
        self.put_latency = put_latency
        self.get_first_byte = get_first_byte
        self.list_latency = list_latency
        self.bandwidth = bandwidth
        self.metrics = ObjectMetrics()
        # prefix "(bucket, layer, target)" → {key: (handle, blob)}
        self._store: Dict[Tuple[int, int, int], Dict[str, Tuple[ObjectHandle, Chunk]]] = {}
        # Optional chaos hook (repro_torch.faas.chaos.ChaosState); when set, PUT /
        # GET / LIST consult it for throttles (SlowDown / 429).  None in
        # production runs — zero overhead, zero billing drift.
        self.chaos = None

    def _maybe_throttle(self, stream: str, at_time: float) -> float:
        if self.chaos is not None:
            at_time, n = self.chaos.throttle(stream, at_time)
            self.metrics.throttle_retries += n
        return at_time

    def _prefix(self, layer: int, target: int) -> Tuple[int, int, int]:
        return (target % self.n_buckets, layer, target)

    def put_obj(
        self, layer: int, src: int, target: int, blob: Chunk | None, at_time: float,
        *, ledger_at: Optional[float] = None,
    ) -> float:
        """PUT one object (or the 0-byte .nul marker); returns completion time.

        ``ledger_at`` is the PUT start on the overlapped-pipeline timeline; it
        only stamps the handle's ``ledger_visible_at`` and never affects
        billing or the phased visibility schedule."""
        at_time = self._maybe_throttle("s3_put", at_time)
        self.metrics.puts += 1
        is_nul = blob is None or len(blob) == 0
        size = 0 if is_nul else len(blob)
        done = at_time + self.put_latency + size / self.bandwidth
        led_done = (None if ledger_at is None
                    else ledger_at + self.put_latency + size / self.bandwidth)
        led_eager = (None if ledger_at is None
                     else ledger_at + self.put_latency / 2
                     + size / self.bandwidth)
        ext = "nul" if is_nul else "dat"
        key = f"{src}_{target}.{ext}"
        handle = ObjectHandle(key=key, size=size, visible_at=done, is_nul=is_nul,
                              src=src, ledger_visible_at=led_done,
                              ledger_eager_visible_at=led_eager)
        self._store.setdefault(self._prefix(layer, target), {})[key] = (
            handle,
            blob if blob is not None else Chunk(b"", 0),
        )
        if is_nul:
            self.metrics.nul_files += 1
        else:
            self.metrics.bytes_written += size
            self.metrics.raw_bytes += blob.raw_bytes
        return done

    def put_multipart(
        self, layer: int, src: int, target: int, blobs: List[Chunk], at_time: float,
        *, ledger_at: Optional[float] = None,
    ) -> float:
        """Large sends: object storage allows effectively unlimited object
        size, so multiple chunks to one target become one object (paper:
        'each FaaS instance only needs to write a single object for each of
        its targets in a given layer')."""
        if not blobs:
            if ledger_at is None:
                return self.put_obj(layer, src, target, None, at_time)
            return self.put_obj(layer, src, target, None, at_time,
                                ledger_at=ledger_at)
        joined = b"".join(
            len(b).to_bytes(8, "little") + bytes(b) for b in blobs
        )
        chunk = Chunk(joined, raw_bytes=sum(b.raw_bytes for b in blobs))
        if ledger_at is None:
            return self.put_obj(layer, src, target, chunk, at_time)
        return self.put_obj(layer, src, target, chunk, at_time,
                            ledger_at=ledger_at)

    def put_multiparts(
        self, layer: int, src: int,
        target_blobs: List[Tuple[int, List[Chunk]]], at_time: float,
        lanes: int = 8,
        *, ledger_at: Optional[float] = None,
    ):
        """PUT one multipart object (or ``.nul``) per (target, chunks) pair,
        round-robin over ``lanes`` concurrent connections starting at
        ``at_time``; returns the per-lane completion times.  Billing is
        exactly one ``put_multipart`` per target — the one-call entry point
        the fleet send path uses for a layer's whole PUT schedule.

        With ``ledger_at`` set, the same lane schedule is mirrored on the
        overlapped timeline (identical ``i % lanes`` assignment) and the
        return is ``(lane_time, ledger_lane_time)``."""
        lane_time = [at_time] * max(1, lanes)
        led_lanes = None if ledger_at is None else [ledger_at] * len(lane_time)
        for i, (target, blobs) in enumerate(target_blobs):
            lane = i % len(lane_time)
            if led_lanes is None:
                lane_time[lane] = self.put_multipart(
                    layer, src, target, blobs, lane_time[lane]
                )
            else:
                lane_time[lane] = self.put_multipart(
                    layer, src, target, blobs, lane_time[lane],
                    ledger_at=led_lanes[lane],
                )
                # mirror put_obj's duration arithmetic (length-prefixed join)
                size = sum(len(b) + 8 for b in blobs) if blobs else 0
                led_lanes[lane] += self.put_latency + size / self.bandwidth
        if ledger_at is None:
            return lane_time
        return lane_time, led_lanes

    @staticmethod
    def split_multipart(blob: bytes) -> List[bytes]:
        out, off = [], 0
        while off < len(blob):
            n = int.from_bytes(blob[off : off + 8], "little")
            off += 8
            out.append(blob[off : off + n])
            off += n
        return out

    def list_files(self, layer: int, worker: int, at_time: float) -> Tuple[float, List[ObjectHandle]]:
        """LIST the worker's own prefix; only handles already visible show up."""
        at_time = self._maybe_throttle("s3_list", at_time)
        self.metrics.lists += 1
        now = at_time + self.list_latency
        entries = self._store.get(self._prefix(layer, worker), {})
        visible = [h for h, _ in entries.values() if h.visible_at <= now]
        return now, sorted(visible, key=lambda h: h.key)

    def get_obj(self, layer: int, worker: int, key: str, at_time: float) -> Tuple[float, Chunk]:
        at_time = self._maybe_throttle("s3_get", at_time)
        self.metrics.gets += 1
        handle, blob = self._store[self._prefix(layer, worker)][key]
        now = at_time + self.get_first_byte + handle.size / self.bandwidth
        return now, blob
