"""Hierarchical worker launch (paper §III, `worker_invoke_children`).

Workers form a B-ary tree in heap numbering: worker ``m`` invokes children
``m*B + 1 + i`` for ``i < B`` (while < P).  Each worker derives its own rank
from (parent id, sibling number, branching factor), so no central registry is
needed — objective 3 of §II-B.  Spreading invocation across all internal
nodes parallelizes the cold-start cascade; the paper reports this beats both
a centralized single-loop launch and Lambada's two-level loop.

`launch_schedule` returns per-worker ready times under a latency model, and
the comparison helpers reproduce that claim as a benchmark.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["TreeSpec", "children_of", "parent_of", "launch_schedule",
           "warm_pool_schedule", "central_launch_schedule",
           "two_level_launch_schedule"]


@dataclasses.dataclass(frozen=True)
class TreeSpec:
    n_workers: int
    branching: int = 4

    def children(self, m: int) -> List[int]:
        return children_of(m, self.n_workers, self.branching)

    def parent(self, m: int) -> int:
        return parent_of(m, self.branching)

    def depth(self, m: int) -> int:
        d = 0
        while m > 0:
            m = parent_of(m, self.branching)
            d += 1
        return d

    def is_leaf(self, m: int) -> bool:
        return not self.children(m)


def children_of(m: int, P: int, B: int) -> List[int]:
    return [c for c in range(m * B + 1, m * B + 1 + B) if c < P]


def parent_of(m: int, B: int) -> int:
    if m == 0:
        raise ValueError("root has no parent")
    return (m - 1) // B


def _tree_schedule(
    P: int, branching: int, invoke_latency: float, cold_start: float,
    jitter: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """(invoked_at, ready) for the hierarchical tree launch with per-worker
    cold-start jitter already drawn."""
    invoked = np.zeros(P)
    ready = np.zeros(P)
    ready[0] = cold_start + jitter[0]
    # BFS in heap order is already topological: parent < child index-wise
    for m in range(P):
        t = ready[m]
        for i, c in enumerate(children_of(m, P, branching)):
            invoked[c] = t + (i + 1) * invoke_latency
            ready[c] = invoked[c] + cold_start + jitter[c]
    return invoked, ready


def launch_schedule(
    P: int,
    branching: int = 4,
    invoke_latency: float = 0.050,
    cold_start: float = 0.250,
    cold_start_jitter: float = 0.0,
    seed: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Ready time of every worker under the hierarchical tree launch.

    A worker becomes *ready* after its own cold start; it then issues its
    child invocations sequentially (each costs `invoke_latency` of its own
    time) before starting compute — matching the paper's design where
    invoking the sub-tree is 'a precursor to executing its compute role'.

    Jitter draws come from ``rng`` when given (``SimulatorConfig`` threads
    its launch stream here), else from a generator seeded with ``seed`` —
    either way the schedule is a pure function of its inputs.
    """
    if rng is None:
        rng = np.random.default_rng(seed)
    jitter = rng.random(P) * cold_start_jitter
    _, ready = _tree_schedule(P, branching, invoke_latency, cold_start, jitter)
    return ready


def warm_pool_schedule(
    P: int,
    branching: int = 4,
    invoke_latency: float = 0.050,
    cold_start: float = 0.250,
    cold_start_jitter: float = 0.0,
    seed: int = 0,
    rng: Optional[np.random.Generator] = None,
    weight_load_s: float | np.ndarray = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Warm-pool policy: the same tree launch cascade runs BEFORE the request
    arrives, and every worker pre-loads its weight shard; the pool is
    declared hot when the last worker finishes, and the request epoch is
    re-based to that instant.

    Returns ``(ready, provision_s)``: ``ready`` is all-zeros (every worker is
    idle-hot at the request epoch) and ``provision_s[m]`` is worker ``m``'s
    billed pre-request runtime — from its invocation (Lambda bills init
    duration) through pool-hot — the input to
    :func:`repro_torch.core.cost_model.warm_pool_cost`.  Same jitter stream as
    :func:`launch_schedule`, so warm and on-demand runs of one seed draw
    identical cold starts.
    """
    if rng is None:
        rng = np.random.default_rng(seed)
    jitter = rng.random(P) * cold_start_jitter
    invoked, ready = _tree_schedule(P, branching, invoke_latency, cold_start,
                                    jitter)
    loaded = ready + np.broadcast_to(np.asarray(weight_load_s, float), (P,))
    pool_hot = float(loaded.max())
    provision_s = pool_hot - invoked
    return np.zeros(P), provision_s


def central_launch_schedule(
    P: int, invoke_latency: float = 0.050, cold_start: float = 0.250,
) -> np.ndarray:
    """Coordinator invokes all P workers in one loop."""
    ready = np.zeros(P)
    for m in range(P):
        ready[m] = (m + 1) * invoke_latency + cold_start
    return ready


def two_level_launch_schedule(
    P: int, fan: int | None = None,
    invoke_latency: float = 0.050, cold_start: float = 0.250,
) -> np.ndarray:
    """Lambada-style: coordinator invokes sqrt(P) lieutenants, each invokes
    its slice."""
    fan = fan or max(1, int(np.ceil(np.sqrt(P))))
    ready = np.zeros(P)
    lieutenants = list(range(0, P, fan))
    for j, m in enumerate(lieutenants):
        ready[m] = (j + 1) * invoke_latency + cold_start
        for i, c in enumerate(range(m + 1, min(m + fan, P))):
            ready[c] = ready[m] + (i + 1) * invoke_latency + cold_start
    return ready
