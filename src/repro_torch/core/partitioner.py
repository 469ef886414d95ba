"""Model partitioning for FSD-Inference (paper §II-C, §III, Table III).

The paper row-partitions every (sparse) weight matrix ``W^k`` and the
activation vectors ``x^k`` across ``P`` FaaS workers, using *column-net
hypergraph partitioning* (HGP-DNN, adapting Demirci & Ferhatosmanoglu, ICS'21)
so that (a) compute load (nnz) is balanced and (b) the total inter-worker
communication volume — rows of ``x^{k-1}`` that must travel between workers —
is minimized.  Random partitioning (RP) is the paper's baseline (Table III
shows HGP-DNN beats RP by ~1 OOM of traffic).

Ownership model (row-parallel SpMM, z^k = W^k @ x^{k-1}):

* the worker that owns row ``i`` of ``W^k`` computes and therefore *owns*
  ``x^k[i]``;
* to compute its rows, a worker needs ``x^{k-1}[j]`` for every nonzero column
  ``j`` in its row block — if owned elsewhere, that row must be communicated.

For constant-width networks (the GraphChallenge DNNs: every layer is N×N) we
partition the *neuron index space once, jointly over all layers* — vertex
``v`` is a neuron, its weight is its total nnz across layers, and each column
``j`` of each layer contributes a net ``{j} ∪ {rows with nnz in col j}``.
Joint partitioning is what lets layer-(k) producers sit with their layer-(k+1)
consumers.  For varying-width networks we partition each layer greedily given
the previous layer's placement.

The partitioner here is a greedy hypergraph-growing pass + FM-style
refinement: not PaToH, but the same objective (connectivity-1 cut) and
balance constraint, fully deterministic given a seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Literal, Sequence

import numpy as np

from repro_torch.core.sparse import CSRMatrix

__all__ = [
    "PartitionResult",
    "partition_network",
    "random_partition",
    "block_partition",
    "hypergraph_partition",
    "measure_comm_volume",
    "CommVolumeReport",
    "StageSpec",
    "StagePlan",
    "plan_stages",
]

Method = Literal["hgp", "random", "block"]


@dataclasses.dataclass
class PartitionResult:
    """``parts[k]`` maps row index of layer-k output (= x^k row) → worker id.

    ``parts[0]`` is the placement of the input vector x^0.  For constant-width
    joint partitioning all entries alias the same array.
    """

    P: int
    parts: List[np.ndarray]  # len L+1, parts[k].shape == (N_k,)
    method: str

    def loads(self, layers: Sequence[CSRMatrix]) -> np.ndarray:
        """Per-worker compute load (total nnz of owned rows, all layers)."""
        loads = np.zeros(self.P, dtype=np.int64)
        for k, W in enumerate(layers):
            row_nnz = W.row_nnz()
            np.add.at(loads, self.parts[k + 1], row_nnz)
        return loads

    def imbalance(self, layers: Sequence[CSRMatrix]) -> float:
        loads = self.loads(layers)
        mean = loads.mean()
        return float(loads.max() / mean) if mean > 0 else 1.0


def random_partition(n: int, P: int, seed: int = 0) -> np.ndarray:
    """Balanced random assignment (paper's RP baseline, PaToH 'random')."""
    rng = np.random.default_rng(seed)
    parts = np.arange(n, dtype=np.int32) % P
    rng.shuffle(parts)
    return parts

def block_partition(n: int, P: int) -> np.ndarray:
    """Contiguous row blocks — the naive tensor-parallel default."""
    # ceil-split so every part gets at most ceil(n/P)
    bounds = np.linspace(0, n, P + 1).astype(np.int64)
    parts = np.zeros(n, dtype=np.int32)
    for p in range(P):
        parts[bounds[p] : bounds[p + 1]] = p
    return parts


def _build_nets(layers: Sequence[CSRMatrix]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact per-layer column-net hypergraph over a constant-width network.

    Net ``(k, j)`` pins producer vertex ``j`` plus every row with a nonzero in
    column ``j`` of layer ``k``.  Net ids are ``k*N + j``.  Returns CSR-style
    ``(net_ptr, net_pins, vertex_weights)``, fully vectorized (O(nnz log nnz)).
    """
    n = layers[0].ncols
    L = len(layers)
    vertex_w = np.zeros(n, dtype=np.int64)
    net_id_chunks: List[np.ndarray] = []
    pin_chunks: List[np.ndarray] = []
    for k, W in enumerate(layers):
        vertex_w[: W.nrows] += W.row_nnz()
        rows = np.repeat(np.arange(W.nrows, dtype=np.int64), W.row_nnz())
        cols = W.indices.astype(np.int64)
        base = k * n
        # producer pins (net k*n+j pins vertex j) + consumer pins
        net_id_chunks.append(base + np.arange(n, dtype=np.int64))
        pin_chunks.append(np.arange(n, dtype=np.int64))
        net_id_chunks.append(base + cols)
        pin_chunks.append(rows)
    net_ids = np.concatenate(net_id_chunks)
    pins = np.concatenate(pin_chunks)
    # dedupe (net, pin) pairs
    key = net_ids * n + pins
    key = np.unique(key)
    net_ids = key // n
    pins = (key % n).astype(np.int32)
    # CSR over nets (net ids are already sorted by unique)
    counts = np.bincount(net_ids, minlength=L * n)
    net_ptr = np.zeros(L * n + 1, dtype=np.int64)
    np.cumsum(counts, out=net_ptr[1:])
    return net_ptr, pins, vertex_w


def _vertex_nets(net_ptr: np.ndarray, net_pins: np.ndarray, n: int):
    """Inverse map: for each vertex, the (sorted) list of nets pinning it."""
    n_nets = net_ptr.shape[0] - 1
    nets_of_pins = np.repeat(
        np.arange(n_nets, dtype=np.int64), np.diff(net_ptr)
    )
    order = np.argsort(net_pins, kind="stable")
    out = nets_of_pins[order].astype(np.int64)
    counts = np.bincount(net_pins, minlength=n)
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    return ptr, out


def hypergraph_partition(
    layers: Sequence[CSRMatrix],
    P: int,
    seed: int = 0,
    eps: float = 0.05,
    refine_passes: int = 3,
) -> np.ndarray:
    """Greedy hypergraph-growing + FM refinement on the joint neuron space."""
    n = layers[0].ncols
    for W in layers:
        if W.ncols != n or W.nrows != n:
            raise ValueError("joint HGP requires constant-width layers")
    net_ptr, net_pins, vertex_w = _build_nets(layers)
    vptr, vnets = _vertex_nets(net_ptr, net_pins, n)

    rng = np.random.default_rng(seed)
    cap = (1.0 + eps) * vertex_w.sum() / P

    # Initial solution: contiguous blocks.  Structured DNN sparsity (radix
    # butterflies, conv-like locality) is near-optimal under contiguity, and
    # FM refinement below only ever improves the connectivity-1 cut, so HGP
    # dominates both the block and random baselines by construction.
    parts = block_partition(n, P).copy()
    loads = np.zeros(P, dtype=np.float64)
    np.add.at(loads, parts, vertex_w.astype(np.float64))

    # part_count[net, p]: how many pins of `net` are in part p
    n_nets = net_ptr.shape[0] - 1
    part_count = np.zeros((n_nets, P), dtype=np.int16)
    nets_of_pins = np.repeat(np.arange(n_nets, dtype=np.int64), np.diff(net_ptr))
    np.add.at(part_count, (nets_of_pins, parts[net_pins]), 1)

    # FM-style refinement: move vertices with positive connectivity gain.
    for _ in range(refine_passes):
        moved = 0
        for v in rng.permutation(n):
            a = parts[v]
            nets = vnets[vptr[v] : vptr[v + 1]]
            if not nets.size:
                continue
            counts = part_count[nets]  # [n_nets_v, P]
            # removing v from a: nets where v is the sole pin in a lose a part
            sole = counts[:, a] == 1
            gain_remove = int(sole.sum())
            # adding v to b: nets where b is empty gain a part
            add_cost = (counts == 0).sum(axis=0).astype(np.int64)
            add_cost[a] = gain_remove  # moving to self = no-op
            b = int(np.argmin(add_cost))
            gain = gain_remove - int(add_cost[b])
            if b != a and gain > 0 and loads[b] + vertex_w[v] <= cap:
                parts[v] = b
                loads[a] -= vertex_w[v]
                loads[b] += vertex_w[v]
                part_count[nets, a] -= 1
                part_count[nets, b] += 1
                moved += 1
        if moved == 0:
            break
    return parts


def partition_network(
    layers: Sequence[CSRMatrix],
    P: int,
    method: Method = "hgp",
    seed: int = 0,
    eps: float = 0.05,
) -> PartitionResult:
    """Partition a whole network; returns per-interface row→worker maps."""
    widths = {W.ncols for W in layers} | {W.nrows for W in layers}
    constant = len(widths) == 1
    L = len(layers)
    if method == "random":
        if constant:
            p = random_partition(layers[0].ncols, P, seed)
            parts = [p] * (L + 1)
        else:
            parts = [random_partition(layers[0].ncols, P, seed)]
            parts += [random_partition(W.nrows, P, seed + 1 + k) for k, W in enumerate(layers)]
    elif method == "block":
        if constant:
            p = block_partition(layers[0].ncols, P)
            parts = [p] * (L + 1)
        else:
            parts = [block_partition(layers[0].ncols, P)]
            parts += [block_partition(W.nrows, P) for W in layers]
    elif method == "hgp":
        if constant:
            p = hypergraph_partition(layers, P, seed=seed, eps=eps)
            parts = [p] * (L + 1)
        else:
            # Layer-by-layer greedy: place rows of W^k near their inputs.
            parts = [block_partition(layers[0].ncols, P)]
            for W in layers:
                parts.append(_greedy_layer_partition(W, parts[-1], P, eps))
    else:
        raise ValueError(f"unknown method {method!r}")
    return PartitionResult(P=P, parts=list(parts), method=method)


def _greedy_layer_partition(
    W: CSRMatrix, prev_parts: np.ndarray, P: int, eps: float
) -> np.ndarray:
    """Assign rows of W to the part owning most of their input rows."""
    row_nnz = W.row_nnz()
    cap = (1.0 + eps) * row_nnz.sum() / P
    loads = np.zeros(P, dtype=np.float64)
    parts = np.zeros(W.nrows, dtype=np.int32)
    order = np.argsort(-row_nnz)
    for i in order:
        cols, _ = W.row(i)
        if cols.size:
            affinity = np.bincount(prev_parts[cols], minlength=P).astype(np.float64)
        else:
            affinity = np.zeros(P)
        affinity -= 1e-9 * loads
        affinity[loads + row_nnz[i] > cap] = -np.inf
        p = int(np.argmax(affinity)) if not np.all(np.isinf(affinity)) else int(np.argmin(loads))
        parts[i] = p
        loads[p] += row_nnz[i]
    return parts


@dataclasses.dataclass
class CommVolumeReport:
    """Exact communication accounting for a partition (Table III analogue)."""

    total_rows_sent: int            # Σ over layers of rows crossing workers
    total_bytes_sent: int           # rows × bytes_per_row (batch dependent)
    per_layer_rows: np.ndarray      # [L]
    per_worker_sent_rows: np.ndarray  # [P]
    mean_rows_per_target: float     # paper's "NNZ sent per target" analogue
    max_worker_rows: int

    @property
    def imbalance(self) -> float:
        m = self.per_worker_sent_rows.mean()
        return float(self.per_worker_sent_rows.max() / m) if m > 0 else 1.0


def measure_comm_volume(
    layers: Sequence[CSRMatrix],
    result: PartitionResult,
    bytes_per_row: int = 4 * 1,
) -> CommVolumeReport:
    """Exact per-layer comm volume: a row of x^{k-1} travels once per distinct
    remote consumer worker (the FSI channels send per-target copies)."""
    P = result.P
    L = len(layers)
    per_layer = np.zeros(L, dtype=np.int64)
    per_worker = np.zeros(P, dtype=np.int64)
    pair_counts = []
    for k, W in enumerate(layers):
        src_parts = result.parts[k]       # owner of x^{k-1} rows
        dst_parts = result.parts[k + 1]   # owner of W^k rows
        rows = np.repeat(np.arange(W.nrows, dtype=np.int64), W.row_nnz())
        cols = W.indices.astype(np.int64)
        src = src_parts[cols]
        dst = dst_parts[rows]
        remote = src != dst
        if remote.any():
            # distinct (col j, src worker, dst worker) triples ⇒ one row send
            key = (cols[remote] * P + src[remote]) * P + dst[remote]
            uniq = np.unique(key)
            per_layer[k] = uniq.shape[0]
            senders = (uniq // P) % P
            np.add.at(per_worker, senders, 1)
            pairs = np.unique(uniq % (P * P))
            pair_counts.append((uniq.shape[0], pairs.shape[0]))
        else:
            pair_counts.append((0, 0))
    total_rows = int(per_layer.sum())
    total_pairs = sum(p for _, p in pair_counts)
    return CommVolumeReport(
        total_rows_sent=total_rows,
        total_bytes_sent=total_rows * bytes_per_row,
        per_layer_rows=per_layer,
        per_worker_sent_rows=per_worker,
        mean_rows_per_target=(total_rows / total_pairs) if total_pairs else 0.0,
        max_worker_rows=int(per_worker.max(initial=0)),
    )


# ---------------------------------------------------------------------------
# Pipeline-stage planning for the serverless LM executor
# ---------------------------------------------------------------------------
#
# The FSI partitioners above split a *constant-width sparse network* row-wise
# (data parallel over neurons).  LM serving over the FaaS fabric splits the
# other way: the layer stack is cut into P **contiguous stages**, each stage
# runs as one worker with its layer slice (and KV cache) resident, and only
# the [B, S, d_model] activation crosses a stage boundary — the pipeline
# analogue of the paper's "send only the rows the consumer needs".


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One contiguous slice of the layer stack.

    ``start``/``stop`` are global layer indices (``[start, stop)``).
    ``has_embed`` marks the stage that owns the token embedding (always the
    first); ``has_head`` marks the stage that owns the final norm + unembed
    (always the last).  With tied embeddings the table is resident on both —
    the real deployment replicates it, and the weight-load bill reflects
    that."""

    index: int
    start: int
    stop: int
    has_embed: bool
    has_head: bool

    @property
    def n_layers(self) -> int:
        return self.stop - self.start


@dataclasses.dataclass(frozen=True)
class StagePlan:
    P: int
    n_layers: int
    stages: tuple  # Tuple[StageSpec, ...]

    def __post_init__(self):
        assert self.stages[0].start == 0
        assert self.stages[-1].stop == self.n_layers


def plan_stages(layer_costs: Sequence[float], P: int) -> StagePlan:
    """Cut ``len(layer_costs)`` layers into P contiguous, non-empty stages
    balancing cumulative cost (cost = FLOPs or parameter bytes per layer —
    any nonnegative weight; uniform costs give an even split).

    Boundary ``i`` lands where the cumulative cost crosses ``total·i/P``,
    then boundaries are repaired so every stage keeps ≥1 layer — the planner
    is deterministic and never emits an empty stage.
    """
    L = len(layer_costs)
    if P < 1:
        raise ValueError(f"P must be >= 1, got {P}")
    if P > L:
        raise ValueError(f"cannot cut {L} layers into {P} non-empty stages")
    costs = np.asarray(layer_costs, dtype=np.float64)
    if (costs < 0).any():
        raise ValueError("layer costs must be nonnegative")
    cum = np.cumsum(costs)
    total = cum[-1] if cum[-1] > 0 else float(L)
    if cum[-1] <= 0:
        cum = np.arange(1, L + 1, dtype=np.float64)
    # ideal boundary after the layer where cumsum crosses total*i/P
    bounds = [0]
    for i in range(1, P):
        b = int(np.searchsorted(cum, total * i / P, side="left")) + 1
        # keep at least one layer per stage on both sides
        b = max(b, bounds[-1] + 1)
        b = min(b, L - (P - i))
        bounds.append(b)
    bounds.append(L)
    stages = tuple(
        StageSpec(index=i, start=bounds[i], stop=bounds[i + 1],
                  has_embed=(i == 0), has_head=(i == P - 1))
        for i in range(P)
    )
    return StagePlan(P=P, n_layers=L, stages=stages)
