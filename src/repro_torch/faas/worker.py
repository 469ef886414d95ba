"""Per-worker state for the simulated Lambda fleet.

Two clock models live here:

* the **phased clock** (``WorkerState.clock``) — the strict-sum model every
  fabric interaction is driven by: each layer's pack → publish → local MVP →
  drain → finish charges accumulate serially.  This clock decides *when*
  messages are published and polled, so every billable count (publish units,
  SQS calls, S3 requests, wire bytes) derives from it alone;
* the **event ledger** (``EventLedger``) — the overlapped-pipeline model:
  separate compute and channel timelines per worker, merged only at true
  dependency edges (a publish needs its payload packed; a layer finish needs
  the drain complete).  The ledger never touches the fabric — it re-times
  the exact events the phased clock executed — so switching the reported
  timeline between the two models cannot change a single charge count.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np

__all__ = ["WorkerState", "EventLedger", "ComputeModel",
           "ModelStageWorker", "estimate_worker_memory_bytes"]


@dataclasses.dataclass
class EventLedger:
    """Dual-timeline event ledger for the overlapped layer pipeline.

    ``t_compute`` carries pack, SpMM, and epilogue work; ``t_channel``
    carries publish lane occupancy and the receiver thread's unpack work.
    Both are *absolute* seconds (same epoch as ``WorkerState.abs_time``) and
    monotone by construction — every mutator takes ``max`` with the current
    value before adding, so a dependency edge can only delay an event, never
    rewind a timeline.
    """

    t_compute: float = 0.0
    t_channel: float = 0.0
    # Eager polling: the receiver thread parks its long-poll / LIST loop for
    # layer l+1 while the layer-l publisher is still packing, so a chunk's
    # availability is its *eager* stamp (one-way publish half-trip + fan-out
    # + push half of the poll RTT) instead of the blocked-reader stamp.
    # Pure re-timing: the phased clock still drives every fabric call, so no
    # billable count can move.
    eager_poll: bool = False

    @property
    def done(self) -> float:
        """The worker is finished when both timelines drain."""
        return max(self.t_compute, self.t_channel)

    def recv_available(self, lazy_at: float,
                       eager_at: Optional[float]) -> float:
        """Availability stamp a drain should gate ``receive`` on: the eager
        stamp when this ledger polls eagerly and the sender recorded one,
        else the blocked-reader stamp."""
        if self.eager_poll and eager_at is not None:
            return eager_at
        return lazy_at

    def compute(self, seconds: float) -> None:
        self.t_compute += seconds

    def channel_busy_from(self, ready: float, seconds: float) -> float:
        """Occupy the channel timeline with a send that cannot start before
        ``ready`` (its payload's pack completion); returns the finish time."""
        self.t_channel = max(self.t_channel, ready) + seconds
        return self.t_channel

    def receive(self, available_at: float, seconds: float) -> None:
        """Receiver-thread work on a chunk that became available (service
        side) at ``available_at``: the thread is blocked in a long poll /
        LIST loop, so the data is in hand at availability and only the
        deserialize/stream cost occupies the channel timeline."""
        self.t_channel = max(self.t_channel, available_at) + seconds

    def join_compute(self) -> None:
        """Dependency edge channel → compute (e.g. a layer finish needs the
        drain complete): compute may not proceed past the channel timeline."""
        self.t_compute = max(self.t_compute, self.t_channel)

    def sync(self, seconds: float) -> None:
        """A fleet-wide stall that occupies the whole worker (cold start,
        weight reload on re-invoke): both timelines meet, then advance."""
        t = self.done + seconds
        self.t_compute = t
        self.t_channel = t

    def sync_to(self, t_abs: float) -> None:
        """Advance both timelines to an absolute release time (collectives)."""
        self.t_compute = max(self.t_compute, t_abs)
        self.t_channel = max(self.t_channel, t_abs)


@dataclasses.dataclass
class ComputeModel:
    """Maps work to seconds on a Lambda instance.

    AWS allocates ~1 vCPU per 1769MB of configured memory (capped at 6);
    effective numpy SpMM throughput per vCPU is taken from public Lambda
    measurements (~1.8 GFLOP/s for scipy-like sparse kernels).
    """

    flops_per_vcpu: float = 1.8e9
    pack_bandwidth: float = 400e6    # zlib level-1 compress, B/s
    unpack_bandwidth: float = 900e6  # zlib decompress, B/s
    max_vcpus: float = 6.0
    vcpu_per_mb: float = 1.0 / 1769.0

    def vcpus(self, memory_mb: int) -> float:
        return min(self.max_vcpus, max(0.07, memory_mb * self.vcpu_per_mb))

    def flops_seconds(self, flops: float, memory_mb: int) -> float:
        return flops / (self.flops_per_vcpu * self.vcpus(memory_mb))


@dataclasses.dataclass
class WorkerState:
    rank: int
    memory_mb: int
    clock: float = 0.0               # seconds since its own invocation epoch
    start_time: float = 0.0          # absolute ready time from the launch tree
    slowdown: float = 1.0            # straggler factor on compute
    flops: float = 0.0
    bytes_sent: int = 0
    bytes_received: int = 0
    messages_sent: int = 0
    messages_received: int = 0
    mem_high_water: int = 0
    # Overlapped-pipeline timelines; None outside run_fsi (unit tests that
    # drive helpers directly get the phased clock only).
    ledger: Optional[EventLedger] = None

    @property
    def abs_time(self) -> float:
        return self.start_time + self.clock

    @property
    def overlap_time(self) -> float:
        """Absolute finish time under the overlapped model (falls back to the
        phased clock when no ledger is attached)."""
        return self.ledger.done if self.ledger is not None else self.abs_time

    def advance_to_abs(self, t_abs: float) -> None:
        self.clock = max(self.clock, t_abs - self.start_time)

    def charge_compute(self, flops: float, model: ComputeModel) -> None:
        self.flops += flops
        s = model.flops_seconds(flops, self.memory_mb) * self.slowdown
        self.clock += s
        if self.ledger is not None:
            self.ledger.compute(s)

    def charge_seconds(self, s: float) -> None:
        self.clock += s

    def touch_memory(self, n_bytes: int) -> None:
        self.mem_high_water = max(self.mem_high_water, n_bytes)


# ---------------------------------------------------------------------------
# Model-stage executor — the LM-pipeline sibling of the FSI worker
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ModelStageWorker:
    """One pipeline stage of an LM, resident on one FaaS worker.

    Holds the stage's sliced parameter subtree and its KV cache between
    decode steps (KV residency: the cache never crosses a stage boundary —
    only the [B, S, d] / [B, 1, d] activation does).  The compute functions
    are injected (jitted closures over the family's stage fns), so this
    module stays framework-free.

    ``weight_bytes`` is the stage slice's actual parameter footprint — the
    quantity ``charge_weight_load`` bills at worker startup, so a stage is
    never billed the full-model load.  ``flops_per_token`` is the stage's
    active-parameter FLOPs for one token (prefill multiplies by the prompt
    length).
    """

    spec: Any                              # core.partitioner.StageSpec
    params: Any                            # sliced stage parameter pytree
    prefill_fn: Callable[..., Any]         # (params, x_in, max_len) -> (out, cache)
    decode_fn: Callable[..., Any]          # (params, x_in, cache) -> (out, cache)
    weight_bytes: int = 0
    flops_per_token: float = 0.0
    cache: Any = None                      # worker-resident KV cache

    def reset(self) -> None:
        self.cache = None

    def run_prefill(self, x_in, max_len: int, extra=None):
        if extra is not None:
            out, self.cache = self.prefill_fn(self.params, x_in, max_len, extra)
        else:
            out, self.cache = self.prefill_fn(self.params, x_in, max_len)
        return out

    def run_decode(self, x_in):
        if self.cache is None:
            raise RuntimeError(
                f"stage {self.spec} decode before prefill: no resident cache")
        out, self.cache = self.decode_fn(self.params, x_in, self.cache)
        return out


PY_OVERHEAD = 1.4  # interpreter + allocator overhead on top of raw buffers


def estimate_worker_memory_bytes(
    weight_nnz: int, max_needed_rows: int, max_out_rows: int, batch: int,
    bytes_per_nnz: int = 8, act_bytes: int = 4,
) -> int:
    """Peak resident bytes: CSR weights + input/output activation panels
    (double-buffered across the layer boundary) + one in-flight message."""
    weights = weight_nnz * bytes_per_nnz
    acts = (max_needed_rows + max_out_rows) * batch * act_bytes
    return int((weights + acts) * PY_OVERHEAD)
