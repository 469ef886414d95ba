"""Pipeline-parallel LM serving over the serverless fabric.

``run_lm_pipeline`` is the LM twin of ``run_fsi``: a model's layer stack is
cut into P contiguous stages (``core.partitioner.plan_stages``), each stage
runs as one simulated FaaS worker (``faas.worker.ModelStageWorker``) with its
parameter slice and KV cache resident, and only the activation crosses a
stage boundary — prefill blocks ([B, S, d] split into payload-capped chunks)
and per-token decode activations ([B, 1, d]) travel over the *same*
``QueueFabric``/``ObjectFabric`` channels, through the *same* publish/drain
helpers, as the FSI exchange.  The sampled token loops back from the head
stage to the embedding stage over the channel as well — every byte of the
serving loop is billed.

Clock model (identical contract to ``run_fsi``): the strict-sum **phased**
clock drives every fabric interaction, so every billable count — publish
units, SQS calls, S3 puts/gets/lists, wire bytes — derives from it alone;
the per-worker **event ledger** re-times the same events on dual
compute/channel timelines.  ``overlap`` only selects which times are
reported; charge counts are bit-identical between the two by construction.

Numerics: chained stages run the monolithic model's per-layer ops at the
same shapes in the same order (the same layer loops over contiguous slices
of the blocks), and the wire ships activations as float32 — which
round-trips the bf16 activations exactly — so on one device the pipeline's
tokens and logits equal the on-device ``ServingEngine``'s bit for bit.

Everything that touches the model runs in PyTorch on the params' device
(the card, or the CPU where the caller's params live there); token ids and
activations cross to the host only to go on the wire.  The rest — stage
planning, the fabrics, the clocks, billing, chaos — is the reference's
numpy code, kept verbatim so every billed count stays the reference's.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Iterator, List, Literal, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import (
    AWS_PRICING,
    CostBreakdown,
    PricingConstants,
    WorkloadStats,
    activation_hop_cost,
    lambda_cost,
    object_cost,
    queue_cost,
)
from repro_torch.core.fsi import (
    _object_drain_one,
    _object_put_targets,
    _queue_drain_one,
    _queue_publish_entries,
)
from repro_torch.core.partitioner import StagePlan, plan_stages
from repro_torch.faas.chaos import FaultPlan
from repro_torch.faas.launch_tree import launch_schedule
from repro_torch.faas.object_service import ObjectFabric
from repro_torch.faas.payload import Chunk, pack_rows
from repro_torch.faas.queue_service import QueueFabric
from repro_torch.faas.simulator import LatencyModel, charge_weight_load
from repro_torch.faas.worker import (
    ComputeModel,
    EventLedger,
    ModelStageWorker,
    WorkerState,
)

__all__ = ["LmPipelineResult", "build_stage_executors", "run_lm_pipeline",
           "stage_layer_costs"]

Channel = Literal["queue", "object", "auto"]

_MAX_OBJECT_PART = 8 * 1024 * 1024  # matches the FSI object send path


@dataclasses.dataclass(frozen=True)
class _HopArtifact:
    """The minimal artifact surface the shared FSI drain/put helpers read.

    ``layer`` doubles as the **hop id** — a globally monotone tag, so each
    receiver's expected hop strictly increases and the drains' stale-layer
    drop retires duplicate redeliveries of completed hops for free.
    ``needed_rows`` is the identity row space (activations are dense), so
    the drain's searchsorted lands values at their own row index."""

    layer: int
    recv_expect: Dict[int, int]
    needed_rows: np.ndarray


@dataclasses.dataclass
class LmPipelineResult:
    tokens: np.ndarray            # [B, max_new] greedy-decoded token ids
    logits: np.ndarray            # [B, vocab] final decode-step logits
    channel: Channel
    P: int
    plan: StagePlan
    worker_times: np.ndarray      # per-stage finish times (selected clock)
    stats: WorkloadStats
    cost: CostBreakdown
    raw_exchange_bytes: int       # pre-compression activation volume
    wire_exchange_bytes: int      # compressed bytes on the channel
    metrics: Dict[str, float]

    @property
    def makespan(self) -> float:
        return float(self.worker_times.max())

    @property
    def n_tokens(self) -> int:
        return int(self.tokens.size)

    @property
    def per_token_ms(self) -> float:
        """Billed makespan per generated token (batch-amortized)."""
        return self.makespan / max(1, self.n_tokens) * 1e3

    @property
    def usd_per_1k_tokens(self) -> float:
        return self.cost.total / max(1, self.n_tokens) * 1e3


# ---------------------------------------------------------------------------
# stage planning + executors
# ---------------------------------------------------------------------------


def stage_layer_costs(cfg: ModelConfig) -> List[float]:
    """Per-layer *active* parameter cost — the stage planner's balance weight
    (FLOPs per token ∝ active params; MoE layers weigh their top-k + shared
    experts, not the full expert bank)."""
    D = cfg.d_model
    attn = cfg._attn_params()
    if cfg.family == "moe":
        act_ffn = 3 * D * cfg.moe_d_ff * (
            cfg.experts_per_token + cfg.n_shared_experts
        ) + D * cfg.n_experts
        dense_ffn = 3 * D * cfg.d_ff if cfg.d_ff else act_ffn
        return [
            float(attn + (dense_ffn if l < cfg.first_dense_layers else act_ffn)
                  + 2 * D)
            for l in range(cfg.n_layers)
        ]
    return [float(cfg._block_params())] * cfg.n_layers


def _tensors(tree) -> Iterator[torch.Tensor]:
    """Every tensor of a stage's params or cache: nested dicts and lists of
    tensors and modules (a module's parameters, each once)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(tree) -> int:
    return int(sum(t.numel() * t.element_size() for t in _tensors(tree)))


def _params_device(params) -> torch.device:
    return next(iter(_tensors(params))).device


def build_stage_executors(
    cfg: ModelConfig,
    params: Any,
    P: int,
    attn_backend=None,
) -> List[ModelStageWorker]:
    """Slice ``params`` (the family's module) into P stage executors.

    A stage's params are slices that share the model's tensors; its
    ``weight_bytes`` counts the slice's own tensors, as the reference's
    ``leaf.nbytes`` does (a tied head stage counts the embedding table
    too).  The stage closures call the family's stage functions directly:
    PyTorch runs eagerly, so there is no ``jit`` to cache.  Executors are
    reusable across ``run_lm_pipeline`` calls (channels, clock models);
    each run resets the resident caches.  ``attn_backend`` resolves as the
    engine's does, ``torch-splitk`` built for the params' device."""
    from repro_torch.core.backends import attention_backend_for
    from repro_torch.models.registry import get_stage_model

    attn = attention_backend_for(attn_backend, _params_device(params))
    sm = get_stage_model(cfg, attn_backend=attn)
    plan = plan_stages(stage_layer_costs(cfg), P)
    costs = stage_layer_costs(cfg)
    head_extra = cfg.d_model * cfg.padded_vocab()  # unembed matmul per token
    executors: List[ModelStageWorker] = []
    for spec in plan.stages:
        sp = sm.slice_params(params, spec)

        def prefill_fn(p, x, max_len, extra=None, _spec=spec):
            return sm.prefill(p, _spec, x, max_len, extra)

        def decode_fn(p, x, c, _spec=spec):
            return sm.decode_step(p, _spec, x, c)

        weight_bytes = _nbytes(sp)
        flops = 2.0 * sum(costs[spec.start:spec.stop])
        if spec.has_head:
            flops += 2.0 * head_extra
        executors.append(ModelStageWorker(
            spec=spec, params=sp, prefill_fn=prefill_fn, decode_fn=decode_fn,
            weight_bytes=weight_bytes, flops_per_token=flops,
        ))
    return executors


def _stage_memory_mb(executors: Sequence[ModelStageWorker],
                     pricing: PricingConstants) -> int:
    """Deterministic worker sizing: 2× the largest stage's resident weights
    (activations + KV + interpreter overhead), floor 512MB."""
    need_mb = max(ex.weight_bytes for ex in executors) * 2.0 / 1e6
    return int(min(pricing.max_lambda_memory_mb, max(512, need_mb)))


# ---------------------------------------------------------------------------
# activation hops over the shared FSI channel helpers
# ---------------------------------------------------------------------------


def _send_activation(
    hop: int, values: np.ndarray, src: WorkerState, dst_rank: int,
    channel: Channel, fabric, compute: ComputeModel,
) -> None:
    """Ship one [n_rows, width] float32 activation panel to ``dst_rank``.

    Queue: pack into payload-capped chunks (the "prefill blocks"), batch
    under the SNS caps, publish over lanes — via the exact FSI publish
    helper, so pack charges, lane schedules, and ledger gating are shared.
    Object: one multipart object per hop via the FSI PUT helper."""
    rows = np.arange(values.shape[0], dtype=np.int32)
    if channel == "queue":
        chunks = pack_rows(hop, src.rank, rows, values,
                           fabric.pricing.max_publish_payload)
        raw_total = sum(c.raw_bytes for c in chunks)
        entries = [(dst_rank, c) for c in chunks]
        _queue_publish_entries(entries, src, fabric, compute, raw_total,
                               send_threads=8)
    else:
        chunks = pack_rows(hop, src.rank, rows, values, _MAX_OBJECT_PART)
        art = _HopArtifact(layer=hop, recv_expect={}, needed_rows=rows)
        _object_put_targets(art, src.rank, [(dst_rank, chunks)], src, fabric,
                            compute, 8)


def _drain_activation(
    hop: int, src_rank: int, dst: WorkerState, n_rows: int, width: int,
    channel: Channel, fabric, compute: ComputeModel,
    receipts_out: Optional[List[int]] = None,
) -> np.ndarray:
    """Receive one [n_rows, width] activation panel from ``src_rank`` —
    through the exact FSI drain loops, so (src, seq) dedupe, stale-hop drop,
    receipt deletes, and ledger receive edges are shared with the FSI path
    (and with its fault-fabric test matrix).  ``receipts_out`` defers the
    queue receipt deletes exactly as in the FSI drain — the crash-injection
    path abandons them so the hop redelivers after the visibility timeout."""
    buf = np.zeros((n_rows, width), dtype=np.float32)
    art = _HopArtifact(layer=hop, recv_expect={src_rank: 1},
                       needed_rows=np.arange(n_rows, dtype=np.int32))

    def emit(pos: np.ndarray, vals: np.ndarray) -> None:
        buf[pos] = vals

    if channel == "queue":
        _queue_drain_one(art, dst, fabric, compute, emit,
                         receipts_out=receipts_out)
    else:
        _object_drain_one(art, dst, fabric, compute, emit)
    return buf


# ---------------------------------------------------------------------------
# the pipeline run
# ---------------------------------------------------------------------------


def run_lm_pipeline(
    cfg: ModelConfig,
    prompts: np.ndarray,                  # [B, S] int32 token ids
    params: Any = None,
    *,
    max_new_tokens: int = 8,
    P: int = 2,
    channel: Channel = "queue",
    attn_backend=None,
    memory_mb: Optional[int] = None,
    latency: Optional[LatencyModel] = None,
    compute: Optional[ComputeModel] = None,
    pricing: PricingConstants = AWS_PRICING,
    branching: int = 4,
    seed: int = 0,
    overlap: bool = True,
    eager_poll: bool = True,
    extra: Optional[Any] = None,
    executors: Optional[List[ModelStageWorker]] = None,
    fabric=None,
    faults: Optional[FaultPlan] = None,
    device=None,
) -> LmPipelineResult:
    """Serve ``max_new_tokens`` of greedy decode for ``prompts`` over a
    P-stage serverless pipeline on ``channel``.

    ``params`` — the family's module; ``None`` draws random bf16 weights
    from ``seed`` on ``device`` (default ``"cuda"``, which raises where no
    card is present).  Everything runs on the params' device: token ids
    and activations go to the host only to go on the wire.  ``executors`` —
    prebuilt :func:`build_stage_executors` output, reused across runs
    (caches are reset here).  ``fabric`` — inject a
    fabric instance (fault-model subclasses in tests); must be built for P
    workers on the matching channel (incompatible with ``channel="auto"``).
    ``overlap`` selects the reported clock exactly as in ``run_fsi``; both
    makespans are always in ``metrics``.  ``eager_poll`` re-times ledger
    receives as if each stage's long-poll / LIST loop were already parked
    when the upstream publish landed — ledger-only, billing unchanged.
    ``channel="auto"`` picks queue vs object per stage boundary (and for the
    token loopback) from ``activation_hop_cost`` over the boundary's actual
    activation bytes; the plan lands in ``metrics["chosen_channel_plan"]``.

    ``faults`` arms a seeded :class:`~repro_torch.faas.chaos.FaultPlan`.  Fabric
    injections (API throttles, publish delays) apply to every hop; crash
    sites are keyed ``(stage, hop, "drain")`` — the stage dies after
    draining the hop but before its receipt deletes commit, so queue hops
    redeliver after the visibility timeout and object hops re-GET from the
    durable store.  Recovery re-invokes the stage (invoke + cold start +
    stage weight reload), restores its KV cache from the last durable
    checkpoint (a billed GET; numerically the host-resident cache is
    trusted — the simulator runs stages in-process), and replays any hops
    drained since that checkpoint (recoverable only on the object channel;
    queue inputs were deleted at receipt commit).  KV checkpoints are PUT
    after prefill and every ``checkpoint_every`` decode steps.  ``send`` /
    ``compute`` crash sites and the runtime limit are exercised by
    ``run_fsi``'s full phase matrix, not here.  With a zero-fault plan
    armed, every billed count on the main fabrics stays bit-identical to
    ``faults=None``.

    ``extra``: the vlm family's frontend embeddings ``[B, F, d]`` (a numpy
    array or a tensor), prepended on the embedding stage, as the
    reference's ``extra``.
    """
    latency = latency or LatencyModel()
    compute = compute or ComputeModel()
    prompts = np.asarray(prompts)
    B, S = prompts.shape
    max_len = S + max_new_tokens + (cfg.frontend_tokens or 0)

    if params is None:
        from repro_torch.core.backends import _require_device
        from repro_torch.models.registry import get_model

        gen_dev = _require_device("run_lm_pipeline",
                                  "cuda" if device is None else device)
        params = get_model(cfg, attn_backend="dense-ref").init(
            torch.Generator(device=gen_dev).manual_seed(seed))
    if executors is None:
        executors = build_stage_executors(cfg, params, P,
                                          attn_backend=attn_backend)
    if len(executors) != P:
        raise ValueError(f"got {len(executors)} stage executors for P={P}")
    for ex in executors:
        ex.reset()
    dev = _params_device([ex.params for ex in executors])
    plan = StagePlan(P=P, n_layers=cfg.n_layers,
                     stages=tuple(ex.spec for ex in executors))
    memory_mb = memory_mb or _stage_memory_mb(executors, pricing)

    # ---------------- launch tree + stage workers ---------------------------
    ready = launch_schedule(
        P, branching=branching, invoke_latency=latency.invoke_latency,
        cold_start=latency.cold_start,
        cold_start_jitter=latency.cold_start_jitter, seed=seed,
    )
    workers: List[WorkerState] = []
    for m in range(P):
        w = WorkerState(rank=m, memory_mb=memory_mb, start_time=float(ready[m]),
                        ledger=EventLedger(t_compute=float(ready[m]),
                                           t_channel=float(ready[m]),
                                           eager_poll=eager_poll))
        # stage cold start: only this stage's layer slice is read back —
        # charge_weight_load bills ModelStageWorker.weight_bytes, never the
        # full model (and syncs both ledger timelines: nothing overlaps a
        # weight load)
        charge_weight_load(w, executors[m], latency)
        w.touch_memory(executors[m].weight_bytes)
        workers.append(w)

    # ---------------- fabric(s) ----------------------------------------------
    def _mk_fabric(ch: str):
        if ch == "queue":
            return QueueFabric(
                P, pricing=pricing,
                publish_latency=latency.sns_publish_latency,
                fanout_latency=latency.sns_fanout_latency,
                poll_rtt=latency.sqs_poll_rtt,
                long_poll_window=latency.sqs_long_poll_window,
                seed=seed,
            )
        return ObjectFabric(
            P,
            put_latency=latency.s3_put_latency,
            get_first_byte=latency.s3_get_first_byte,
            list_latency=latency.s3_list_latency,
            bandwidth=latency.s3_bandwidth,
        )

    if channel == "auto":
        if fabric is not None:
            raise ValueError("channel='auto' is incompatible with an "
                             "injected fabric")
        boundary_ch, loop_ch = _lm_autotune_plan(
            B, S, cfg.d_model, P, max_new_tokens, pricing)
        plan_str = "".join(c[0] for c in boundary_ch) + "+" + loop_ch[0]
    elif channel in ("queue", "object"):
        boundary_ch = [channel] * max(0, P - 1)
        loop_ch = channel
        plan_str = None
    else:
        raise ValueError(channel)
    if fabric is not None:
        fabrics = {channel: fabric}
    else:
        fabrics = {ch: _mk_fabric(ch)
                   for ch in dict.fromkeys(list(boundary_ch) + [loop_ch])}
    hops = itertools.count()

    # ---------------- chaos plumbing (faults=None: all of this is inert) ----
    chaos = None
    ckpt_fabric = None
    if faults is not None:
        chaos = faults.activate()
        for fab in fabrics.values():
            fab.chaos = chaos
        ckpt_fabric = ObjectFabric(
            P,
            put_latency=latency.s3_put_latency,
            get_first_byte=latency.s3_get_first_byte,
            list_latency=latency.s3_list_latency,
            bandwidth=latency.s3_bandwidth,
        )
    ckpt_ids = itertools.count()
    last_ckpt: List[Optional[int]] = [None] * P
    # hops drained since each stage's last KV checkpoint: (hop, src, ch,
    # n_tokens) — the replay work a crash at that stage would redo
    unreplayed: List[List[tuple]] = [[] for _ in range(P)]

    def _checkpoint_kv(m: int) -> None:
        """PUT stage m's resident KV cache to the durable checkpoint store.

        The upload rides a background connection: the stage clock pays only
        serialization; the PUT tariff lands on the recovery cost line."""
        w = workers[m]
        nbytes = _nbytes(executors[m].cache)
        s = nbytes / compute.pack_bandwidth * w.slowdown
        w.charge_seconds(s)
        if w.ledger is not None:
            w.ledger.compute(s)
        cid = next(ckpt_ids)
        ckpt_fabric.put_obj(cid, m, m, Chunk(bytes(nbytes), raw_bytes=nbytes),
                            w.abs_time)
        last_ckpt[m] = cid
        unreplayed[m].clear()

    def _recover_stage(m: int, hop_id: int) -> None:
        """Re-invoke crashed stage m: cold start + stage weight reload, KV
        restore from the last durable checkpoint, replay of any hops drained
        since it (object channel only — queue inputs are gone)."""
        w = workers[m]
        chaos.record_reinvoke(
            m, hop_id, "drain",
            "crashed after drain, before receipt delete; re-invoked")
        w.charge_seconds(latency.invoke_latency + latency.cold_start)
        if w.ledger is not None:
            w.ledger.sync(latency.invoke_latency + latency.cold_start)
        charge_weight_load(w, executors[m], latency)
        if last_ckpt[m] is not None:
            now, _ = ckpt_fabric.get_obj(last_ckpt[m], m, f"{m}_{m}.dat",
                                         w.abs_time)
            w.advance_to_abs(now)
            if w.ledger is not None:
                w.ledger.sync_to(w.abs_time)
        for h, src_rank, hch, n_tokens in unreplayed[m]:
            if hch != "object":
                raise chaos.unrecoverable(
                    m, hop_id,
                    f"replaying hop {h} needs its activation re-read, but "
                    f"the queue channel deleted it at receipt commit — "
                    f"lower checkpoint_every so every drained hop is "
                    f"covered by a KV checkpoint, or route boundaries over "
                    f"the object channel")
            now, _ = fabrics["object"].get_obj(h, m, f"{src_rank}_{m}.dat",
                                               w.abs_time)
            w.advance_to_abs(now)
            if w.ledger is not None:
                w.ledger.sync_to(w.abs_time)
            w.charge_compute(executors[m].flops_per_token * n_tokens, compute)

    def drain_hop(hop_id: int, src_rank: int, m: int, n_rows: int,
                  width_: int, ch: str) -> np.ndarray:
        """The fault-aware hop drain.  A doomed drain (armed crash site,
        peeked without consuming) defers its queue receipt deletes and
        abandons them, so the messages stay in flight and redeliver; then
        the stage recovers and drains again."""
        fab = fabrics[ch]
        w = workers[m]
        if chaos is not None and chaos.peek_crash(m, hop_id, "drain"):
            _drain_activation(hop_id, src_rank, w, n_rows, width_, ch, fab,
                              compute,
                              receipts_out=[] if ch == "queue" else None)
            chaos.should_crash(m, hop_id, "drain")  # consume the site
            _recover_stage(m, hop_id)
            buf = _drain_activation(hop_id, src_rank, w, n_rows, width_, ch,
                                    fab, compute)
        else:
            buf = _drain_activation(hop_id, src_rank, w, n_rows, width_, ch,
                                    fab, compute)
        if chaos is not None:
            unreplayed[m].append((hop_id, src_rank, ch, n_rows))
        return buf

    def f32_panel(x: torch.Tensor) -> np.ndarray:
        a = x.detach().to("cpu", torch.float32).numpy()
        return np.ascontiguousarray(a.reshape(-1, a.shape[-1]))

    def on_device(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(a).to(dev).to(dtype)

    def greedy(logits: torch.Tensor) -> torch.Tensor:
        # the first index among equal maxima, as jnp.argmax takes it
        return logits[:, -1:].argmax(dim=-1)

    def charge_stage(m: int, n_tokens: int) -> None:
        w = workers[m]
        if w.ledger is not None:
            w.ledger.join_compute()  # the stage compute needs its drain done
        w.charge_compute(executors[m].flops_per_token * n_tokens, compute)

    # ---------------- prefill chain -----------------------------------------
    extra_in = None
    if extra is not None:
        extra_in = (extra if isinstance(extra, torch.Tensor)
                    else torch.from_numpy(np.asarray(extra, np.float32))).to(dev)
    act_dtype = None
    out = None
    hop = None
    n_rows = width = 0
    for m in range(P):
        w, ex = workers[m], executors[m]
        if m == 0:
            x_in = on_device(prompts.astype(np.int64), torch.int64)
        else:
            ch = boundary_ch[m - 1]
            buf = drain_hop(hop, m - 1, m, n_rows, width, ch)
            x_in = on_device(buf.reshape(B, -1, width), act_dtype)
        n_prefill_tokens = B * (x_in.shape[1] if m else S)
        out = ex.run_prefill(x_in, max_len, extra=extra_in if m == 0 else None)
        charge_stage(m, n_prefill_tokens)
        if chaos is not None:
            _checkpoint_kv(m)
        if m < P - 1:
            act_dtype = out.dtype
            panel = f32_panel(out)
            n_rows, width = panel.shape
            hop = next(hops)
            ch = boundary_ch[m]
            _send_activation(hop, panel, w, m + 1, ch, fabrics[ch], compute)

    token = greedy(out)

    # ---------------- decode loop -------------------------------------------
    out_tokens: List[np.ndarray] = []
    logits = out
    for step in range(max_new_tokens):
        out_tokens.append(token[:, 0].cpu().numpy())
        if P > 1:
            # token loopback: head stage ships the sampled token back to the
            # embedding stage over the channel (a billed hop like any other)
            loop_hop = next(hops)
            _send_activation(
                loop_hop, token.cpu().numpy().astype(np.float32),
                workers[P - 1], 0, loop_ch, fabrics[loop_ch], compute,
            )
            buf = drain_hop(loop_hop, P - 1, 0, B, 1, loop_ch)
            token = on_device(buf.astype(np.int64), torch.int64)
        for m in range(P):
            w, ex = workers[m], executors[m]
            if m == 0:
                x_in = token
            else:
                ch = boundary_ch[m - 1]
                buf = drain_hop(hop, m - 1, m, B, width, ch)
                x_in = on_device(buf[:, None, :], act_dtype)
            out = ex.run_decode(x_in)
            charge_stage(m, B)
            if chaos is not None and step % faults.checkpoint_every == 0:
                _checkpoint_kv(m)
            if m < P - 1:
                act_dtype = out.dtype
                panel = f32_panel(out)
                width = panel.shape[1]
                hop = next(hops)
                ch = boundary_ch[m]
                _send_activation(hop, panel, w, m + 1, ch, fabrics[ch],
                                 compute)
        logits = out
        token = greedy(logits)

    # ---------------- billing ------------------------------------------------
    phased_times = np.array([w.abs_time for w in workers])
    ledger_times = np.array([w.overlap_time for w in workers])
    times = ledger_times if overlap else phased_times
    starts = np.array([w.start_time for w in workers])
    stats = WorkloadStats(
        P=P, mean_runtime_s=float((times - starts).mean()),
        memory_mb=memory_mb,
    )
    raw, wire = 0, 0
    extra_metrics: Dict[str, float] = {}
    if "queue" in fabrics:
        qm = fabrics["queue"].metrics
        stats.publish_units = qm.publish_billed_units
        stats.bytes_sns_to_sqs = qm.bytes_sns_to_sqs
        stats.sqs_api_calls = qm.sqs_api_calls
        raw += qm.raw_bytes
        wire += qm.bytes_sns_to_sqs
        extra_metrics.update({
            "publish_api_calls": qm.publish_api_calls,
            "messages": qm.messages_delivered,
            "empty_polls": qm.empty_polls,
            "redeliveries": qm.redeliveries,
        })
    if "object" in fabrics:
        om = fabrics["object"].metrics
        stats.s3_puts = om.puts
        stats.s3_gets = om.gets
        stats.s3_lists = om.lists
        raw += om.raw_bytes
        wire += om.bytes_written
        extra_metrics["nul_files"] = om.nul_files
    # communication sums both fabrics' tariffs (each is 0 for unused stats)
    cost = CostBreakdown(
        compute=lambda_cost(stats, pricing),
        communication=(queue_cost(stats, pricing).communication
                       + object_cost(stats, pricing).communication),
    )
    if chaos is not None:
        # recovery line: re-invocation fees + durable KV-checkpoint store
        # tariffs; redelivery/replay traffic stays on communication, and the
        # recovery runtime is on compute via mean_runtime_s
        cm = ckpt_fabric.metrics
        ckpt_stats = WorkloadStats(P=P, mean_runtime_s=0.0,
                                   memory_mb=memory_mb, s3_puts=cm.puts,
                                   s3_gets=cm.gets, s3_lists=cm.lists)
        cost.recovery = (sum(chaos.reinvokes.values())
                         * pricing.lambda_invoke
                         + object_cost(ckpt_stats, pricing).communication)

    act_bytes = B * cfg.d_model * 4
    decode_ch = boundary_ch[0] if boundary_ch else loop_ch
    metrics = {
        "flops_total": float(sum(w.flops for w in workers)),
        "phased_makespan_s": float(phased_times.max()),
        "overlap_makespan_s": float(ledger_times.max()),
        "hops": float(next(hops)),
        # analytic per-hop $ (cost-model Eq. 5-7 on one decode activation) —
        # the stage planner's a-priori estimate alongside the billed truth
        "est_decode_hop_usd": activation_hop_cost(decode_ch, act_bytes,
                                                  pricing),
        **{k: float(v) for k, v in extra_metrics.items()},
    }
    if chaos is not None:
        cm = ckpt_fabric.metrics
        metrics.update({
            "recovery_usd": cost.recovery,
            "n_reinvokes": float(sum(chaos.reinvokes.values())),
            "checkpoint_puts": float(cm.puts),
            "checkpoint_bytes": float(cm.bytes_written),
            "throttle_retries": float(sum(
                fab.metrics.throttle_retries for fab in fabrics.values())),
        })
    if plan_str is not None:
        metrics["chosen_channel_plan"] = plan_str
    return LmPipelineResult(
        tokens=np.stack(out_tokens, axis=1).astype(np.int32),
        logits=logits[:, 0].to("cpu", torch.float32).numpy(),
        channel=channel, P=P, plan=plan, worker_times=times, stats=stats,
        cost=cost, raw_exchange_bytes=int(raw), wire_exchange_bytes=int(wire),
        metrics=metrics,
    )


def _lm_autotune_plan(
    B: int, S: int, d_model: int, P: int, max_new_tokens: int,
    pricing: PricingConstants,
):
    """Per-stage-boundary channel choice from the live cost model.

    A boundary ships one [B·S, d] prefill panel plus ``max_new_tokens``
    [B, d] decode panels per request; the planner sums
    ``activation_hop_cost`` over those payloads (chunk header + row ids +
    float32 values, the exact ``pack_rows`` framing) and picks the cheaper
    channel per boundary — ties go to queue (lower latency per hop).  The
    token loopback (head → embedding, [B, 1] per step) is chosen the same
    way.  Deterministic in the request shape, so overlap/phased twins of a
    run see one plan."""
    def hop(ch: str, n_rows: int, width: int) -> float:
        nbytes = 24 + n_rows * (4 + 4 * width)
        return activation_hop_cost(ch, nbytes, pricing)

    boundary: List[str] = []
    for _ in range(max(0, P - 1)):
        cost = {
            ch: hop(ch, B * S, d_model) + max_new_tokens * hop(ch, B, d_model)
            for ch in ("queue", "object")
        }
        boundary.append("queue" if cost["queue"] <= cost["object"]
                        else "object")
    lcost = {ch: max_new_tokens * hop(ch, B, 1) for ch in ("queue", "object")}
    loop = "queue" if lcost["queue"] <= lcost["object"] else "object"
    return boundary, loop
