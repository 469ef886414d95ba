"""Seeded chaos injection + crash-fault recovery primitives (ISSUE 10).

FSD-Inference's correctness story leans on the FaaS platform's
fault-tolerance primitives: SQS at-least-once delivery with
visibility-timeout redelivery, durable object storage as recovery state,
and function re-invocation on failure.  This module is the *injection*
side: a frozen, seeded :class:`FaultPlan` describes which workers die at
which (layer, phase), how often publishes are delayed inside the provider,
how often API calls are throttled (429), and the per-function runtime
limit.  The *recovery* side lives in the executors
(``run_fsi`` / ``run_lm_pipeline``), which re-invoke crashed workers,
restore their panels from durable checkpoints, and replay the layer
handler — every extra invocation, redelivery, GET, and GB-second landing
on auditable ``CostBreakdown`` lines.

Determinism: every random draw flows from ``FaultPlan.seed`` through
named, stream-separated RNGs (the ``SimulatorConfig.rng`` convention),
and crash draws are *event-keyed* — seeded by ``(worker, layer, phase)``
rather than drawn in call order — so a recovery replay can never shift
which faults fire.  Each fault event fires at most once: a re-invoked
worker does not re-crash at the site it just recovered from (the chaos
driver is modeled as injecting each fault a single time).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["FaultPlan", "FleetFailure", "ChaosState", "CRASH_PHASES"]

#: Phases of one layer handler a worker can be killed in.
#: ``send``    — before the worker publishes its layer-k chunks;
#: ``compute`` — after publishing, before draining (local MVP in flight);
#: ``drain``   — after the drain completed but before the receipt deletes
#:               commit, so the drained messages redeliver after the
#:               visibility timeout.
CRASH_PHASES = ("send", "compute", "drain")


class FleetFailure(RuntimeError):
    """Raised when a fault is not recoverable within the plan's budget.

    Carries structured per-worker diagnostics so callers (and the chaos
    test-suite's exactness assertions) can see *why* the fleet died:
    ``diagnostics[worker] = {"layer", "phase", "reinvokes", "reason"}``.
    """

    def __init__(self, message: str, diagnostics: Dict[int, dict]):
        super().__init__(message)
        self.diagnostics = diagnostics


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, immutable chaos schedule for one run.

    ``kills`` lists explicit ``(worker, layer, phase)`` crash sites (phase
    from :data:`CRASH_PHASES`); ``crash_prob`` additionally arms every
    (worker, layer, phase) site with an independent event-keyed draw.
    ``publish_delay_prob`` models lost publishes as provider-internal
    retries (the message is delivered ``publish_delay_s`` late — lost
    forever is not a thing SNS→SQS promises, so neither do we).
    ``throttle_prob`` injects 429s on fabric API calls, retried with
    capped exponential backoff + full jitter.  ``runtime_limit_s`` kills
    any worker whose billed runtime since (re-)invocation exceeds the
    limit, at the next layer boundary.  ``max_reinvokes`` is the
    per-worker re-invocation budget; exceeding it raises
    :class:`FleetFailure`.  ``checkpoint_every`` is the panel-checkpoint
    cadence C (a checkpoint PUT of each worker's input panel every C
    layers) — crashes above the last checkpoint replay forward from it,
    which needs the intermediate layers' inputs to still be readable
    (durable object channel); see docs/ARCHITECTURE.md for the trade-off.
    """

    seed: int = 0
    kills: Tuple[Tuple[int, int, str], ...] = ()
    crash_prob: float = 0.0
    publish_delay_prob: float = 0.0
    publish_delay_s: float = 0.25
    throttle_prob: float = 0.0
    throttle_max_retries: int = 16
    runtime_limit_s: Optional[float] = None
    max_reinvokes: int = 3
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    checkpoint_every: int = 1

    def __post_init__(self):
        for worker, layer, phase in self.kills:
            if phase not in CRASH_PHASES:
                raise ValueError(f"unknown crash phase {phase!r}")
        if self.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")

    def activate(self) -> "ChaosState":
        return ChaosState(self)


class ChaosState:
    """Mutable per-run state of an activated :class:`FaultPlan`.

    One instance is shared by every fabric of a run (``fabric.chaos``) and
    by the executor's crash checks, so the stream-separated RNGs stay
    coherent across the queue/object/checkpoint fabrics.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._kills = frozenset(plan.kills)
        self._fired: set = set()
        self._rngs: Dict[str, np.random.Generator] = {}
        self.reinvokes: Dict[int, int] = {}
        self.diagnostics: Dict[int, dict] = {}

    # -- stream-separated RNGs (the SimulatorConfig.rng convention) ---------

    def rng(self, stream: str) -> np.random.Generator:
        r = self._rngs.get(stream)
        if r is None:
            r = np.random.default_rng(
                [self.plan.seed, zlib.crc32(stream.encode("utf-8"))]
            )
            self._rngs[stream] = r
        return r

    # -- crash schedule ------------------------------------------------------

    def _armed(self, worker: int, layer: int, phase: str) -> bool:
        key = (worker, layer, phase)
        if key in self._fired:
            return False
        if key in self._kills:
            return True
        if self.plan.crash_prob > 0.0:
            r = np.random.default_rng(
                [self.plan.seed, zlib.crc32(b"crash"), worker, layer,
                 CRASH_PHASES.index(phase)]
            )
            return bool(r.random() < self.plan.crash_prob)
        return False

    def peek_crash(self, worker: int, layer: int, phase: str) -> bool:
        """Whether the site is armed, without consuming it.  The executor
        peeks the ``drain`` site before draining so a doomed drain defers
        its receipt deletes (they must stay in flight to redeliver) while a
        healthy drain keeps the production per-iteration delete schedule —
        a zero-fault plan's billed counts stay bit-identical to no plan."""
        return self._armed(worker, layer, phase)

    def should_crash(self, worker: int, layer: int, phase: str) -> bool:
        """True exactly once per armed (worker, layer, phase) site.

        The probabilistic arm is event-keyed (seeded by the site, not drawn
        in call order) so recovery replays cannot shift later draws.
        """
        hit = self._armed(worker, layer, phase)
        if hit:
            self._fired.add((worker, layer, phase))
        return hit

    def record_reinvoke(self, worker: int, layer: int, phase: str,
                        reason: str) -> None:
        """Count one re-invocation against ``worker``'s budget; raise
        :class:`FleetFailure` when the budget is exhausted."""
        n = self.reinvokes.get(worker, 0) + 1
        self.reinvokes[worker] = n
        self.diagnostics[worker] = {
            "layer": layer, "phase": phase, "reinvokes": n, "reason": reason,
        }
        if n > self.plan.max_reinvokes:
            raise FleetFailure(
                f"worker {worker} exhausted its re-invoke budget "
                f"({n} > {self.plan.max_reinvokes}) at layer {layer} "
                f"({phase}): {reason}",
                dict(self.diagnostics),
            )

    def unrecoverable(self, worker: int, layer: int, reason: str
                      ) -> FleetFailure:
        """Build the structured failure for a crash no replay can fix."""
        self.diagnostics[worker] = {
            "layer": layer, "phase": "recover",
            "reinvokes": self.reinvokes.get(worker, 0), "reason": reason,
        }
        return FleetFailure(
            f"worker {worker} unrecoverable at layer {layer}: {reason}",
            dict(self.diagnostics),
        )

    # -- fabric-side injections ---------------------------------------------

    def throttle(self, stream: str, at_time: float) -> Tuple[float, int]:
        """Model 429s on one API call: each throttled attempt is retried
        after capped exponential backoff with *full jitter* (sleep drawn
        uniformly from [0, min(cap, base·2^attempt)]).  Returns the delayed
        start time and the number of retries taken."""
        p = self.plan.throttle_prob
        if p <= 0.0:
            return at_time, 0
        rng = self.rng("throttle:" + stream)
        n = 0
        while rng.random() < p:
            n += 1
            if n > self.plan.throttle_max_retries:
                raise FleetFailure(
                    f"{stream}: throttled {n} consecutive times — retry "
                    f"budget exhausted",
                    {-1: {"layer": -1, "phase": stream, "reinvokes": 0,
                          "reason": "throttle retry budget exhausted"}},
                )
            cap = min(self.plan.backoff_cap_s,
                      self.plan.backoff_base_s * (2.0 ** (n - 1)))
            at_time += float(rng.random()) * cap
        return at_time, n

    def publish_delay(self) -> float:
        """Extra provider-side delivery delay for one publish call (a
        dropped publish surfacing as an SNS-internal retry)."""
        p = self.plan.publish_delay_prob
        if p <= 0.0:
            return 0.0
        rng = self.rng("publish_delay")
        if rng.random() < p:
            return self.plan.publish_delay_s
        return 0.0
