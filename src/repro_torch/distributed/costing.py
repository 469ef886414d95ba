"""Cost extraction for the dry run's roofline.

The reference reads its counts off a jaxpr and the partitioned HLO.  The
port has neither: it runs the step on ``meta`` tensors (shapes and dtypes,
no storage) under a ``TorchDispatchMode`` that sees every aten op the step
dispatches.

* :func:`trace_step` / :func:`traced_flops`: global FLOPs of ``fn(*args)``.
  Products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``convolution``, ...)
  count exactly ``2·m·n·k`` and are reported apart as ``product_flops``;
  elementwise ops count their output's size and reductions their input's
  (the reference's ``_ELEMENTWISE`` and ``_REDUCE``).  A Python loop and a
  ``torch.utils.checkpoint`` recomputation count as many times as they run,
  which is what the reference gets from its scan multiplier and its remat.
  The same pass records the peak of the storage the step holds live
  (``peak_bytes``), the dry run's temp-memory estimate.
* :func:`step_collectives`: the collectives a cell's placements imply for
  one step (tensor-parallel partial sums over ``model``, gradient
  reductions over the data axes, FSDP / ZeRO gathers, the sequence-sharded
  decode's merge), each with its kind, result shape on one device, dtype,
  group and count; :func:`ring_bytes` prices one with the reference's ring
  formulas (bytes on the wire a device).
* :func:`analytic_hbm_bytes`: the roofline memory term, the minimum HBM
  traffic of a perfectly fused step, verbatim.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (P, _dict_keys,
                                              _divisible_prefix, _dp_for,
                                              _looks_like_attn_wo)
from repro_torch.launch.mesh import MeshAxes
from repro_torch.models import layers as L
from repro_torch.models.hybrid import n_shared_sites

__all__ = ["StepTrace", "trace_step", "traced_flops", "Collective",
           "ring_bytes", "step_collectives", "collective_bytes",
           "analytic_hbm_bytes"]


# ---------------------------------------------------------------------------
# FLOP counting
# ---------------------------------------------------------------------------

_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "exp", "log",
    "tanh", "sigmoid", "rsqrt", "sqrt", "pow", "neg", "abs", "sign", "floor",
    "ceil", "where", "clamp", "clamp_min", "clamp_max", "erf", "cos", "sin",
    "silu", "reciprocal", "exp2", "log1p", "expm1", "softplus", "gelu",
    "silu_backward", "sigmoid_backward", "tanh_backward", "softplus_backward",
}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "cumsum",
           "logcumsumexp", "cummax", "argmax", "argmin", "logsumexp"}


_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm", "mv", "dot", "convolution",
             "convolution_backward"}


def _numel(t) -> int:
    return math.prod(t.shape) if isinstance(t, torch.Tensor) else 1


def _product_flops(func, args, out) -> float:
    """``2·m·n·k`` of a product op of ``_PRODUCTS`` (a convolution: two
    FLOPs a multiply-add of every output element with its input channels
    and taps)."""
    name = func.overloadpacket.__name__
    if name == "mm":
        (m, k), n = args[0].shape, args[1].shape[-1]
        return 2.0 * m * n * k
    if name == "addmm":
        (m, k), n = args[1].shape, args[2].shape[-1]
        return 2.0 * m * n * k
    if name == "bmm":
        b, m, k = args[0].shape
        return 2.0 * b * m * k * args[1].shape[-1]
    if name == "baddbmm":
        b, m, k = args[1].shape
        return 2.0 * b * m * k * args[2].shape[-1]
    if name in ("mv", "dot"):
        return 2.0 * _numel(args[0])
    if name == "convolution":
        w = args[1]
        return 2.0 * _numel(out) * w.shape[1] * math.prod(w.shape[2:])
    if name == "convolution_backward":
        grad_out, w, mask = args[0], args[2], args[10]
        per = 2.0 * _numel(grad_out) * w.shape[1] * math.prod(w.shape[2:])
        return per * (int(bool(mask[0])) + int(bool(mask[1])))
    raise ValueError(f"{name} is not a product")


class StepTrace(TorchDispatchMode):
    """The FLOP counter and live-storage tracker of :func:`trace_step`.

    Ops that return fresh tensors (no view, no in-place write) are run once
    a signature (op, the inputs' shapes, strides and dtypes, the other
    arguments) on ``meta`` and then answered from that record: the meta
    kernels are Python reference implementations, and a step at full width
    repeats each of a few hundred signatures thousands of times."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.product_flops = 0.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._memo: Dict[Any, Any] = {}
        self._kind: Dict[Any, Tuple[bool, str]] = {}

    # -- storage ----------------------------------------------------------
    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key)

    # -- memo -------------------------------------------------------------
    @staticmethod
    def _sig(x):
        if isinstance(x, torch.Tensor):
            return (x.shape, x.stride(), x.dtype, x.device.type)
        if isinstance(x, (list, tuple)):
            return tuple(StepTrace._sig(v) for v in x)
        if isinstance(x, (int, float, bool, str, type(None), torch.dtype,
                          torch.device, torch.layout, torch.memory_format)):
            return x
        raise TypeError

    def _kind_of(self, func) -> Tuple[bool, str]:
        """(whether the op returns fresh tensors, its FLOP class:
        ``"product"``, ``"elementwise"``, ``"reduce"`` or ``""``)."""
        kind = self._kind.get(func)
        if kind is None:
            schema = func._schema
            fresh = (not schema.is_mutable and len(schema.returns) > 0
                     and all(r.alias_info is None for r in schema.returns))
            name = func.overloadpacket.__name__.rstrip("_")
            cls = ("product" if name in _PRODUCTS else "elementwise"
                   if name in _ELEMENTWISE else "reduce" if name in _REDUCE
                   else "")
            kind = self._kind[func] = (fresh, cls)
        return kind

    def _run(self, func, args, kwargs, fresh: bool):
        if not fresh:
            return func(*args, **kwargs)
        try:
            key = (func, self._sig(args), self._sig(tuple(sorted(kwargs.items()))))
        except TypeError:
            return func(*args, **kwargs)
        rec = self._memo.get(key)
        if rec is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (list, tuple)) else (out,)
            if all(isinstance(o, torch.Tensor) and o.device.type == "meta"
                   for o in outs):
                self._memo[key] = (isinstance(out, (list, tuple)), type(out),
                                   [(tuple(o.shape), o.stride(), o.dtype)
                                    for o in outs])
            return out
        many, kind, specs = rec
        outs = [torch.empty_strided(s, st, dtype=dt, device="meta")
                for s, st, dt in specs]
        return kind(outs) if many else outs[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        fresh, cls = self._kind_of(func)
        out = self._run(func, args, kwargs, fresh)
        if cls == "product":
            prod = _product_flops(func, args, out)
            self.flops += prod
            self.product_flops += prod
        elif cls == "elementwise":
            self.flops += _numel(out if isinstance(out, torch.Tensor) else args[0])
        elif cls == "reduce":
            self.flops += _numel(args[0])
        for o in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(o, torch.Tensor):
                self._track(o)
        return out


def trace_step(fn, *args, **kwargs) -> Tuple[Any, StepTrace]:
    """``(fn(*args, **kwargs), trace)``: the step's output and its
    :class:`StepTrace` (global ``flops``, ``product_flops``,
    ``peak_bytes``)."""
    trace = StepTrace()
    with trace:
        out = fn(*args, **kwargs)
    return out, trace


def traced_flops(fn, *args, **kwargs) -> float:
    """Global (unpartitioned) FLOPs of ``fn(*args)``."""
    return trace_step(fn, *args, **kwargs)[1].flops


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def ring_bytes(kind: str, result_bytes: float, group: int) -> float:
    """On-wire bytes a device for one collective (ring algorithms), from
    its result's size S on one device and its group size g:

    all-reduce 2·S·(g-1)/g; all-gather S·(g-1)/g (S the gathered result);
    reduce-scatter S·(g-1) (the input is S·g); all-to-all S·(g-1)/g;
    collective-permute S."""
    g = int(group)
    if g <= 1:
        return 0.0
    size = float(result_bytes)
    if kind == "all-reduce":
        return 2.0 * size * (g - 1) / g
    if kind == "all-gather":
        return size * (g - 1) / g
    if kind == "reduce-scatter":
        return size * (g - 1)
    if kind == "all-to-all":
        return size * (g - 1) / g
    return size  # collective-permute


@dataclasses.dataclass(frozen=True)
class Collective:
    """``count`` collectives of ``kind`` whose result on one device has
    ``shape`` and ``dtype``, over a group of ``group`` devices; ``what``
    says which value."""

    kind: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    group: int
    count: int
    what: str

    @property
    def result_bytes(self) -> int:
        return math.prod(self.shape) * torch.empty((), dtype=self.dtype).element_size()

    def wire_bytes(self) -> float:
        """Bytes on the wire a device, all ``count`` of them."""
        return self.count * ring_bytes(self.kind, self.result_bytes, self.group)


def collective_bytes(colls: List[Collective]) -> Tuple[Dict[str, float], float]:
    """(bytes a device by kind, total), as the reference's
    ``collective_bytes`` reports them."""
    per: Dict[str, float] = {}
    for c in colls:
        b = c.wire_bytes()
        if b:
            per[c.kind] = per.get(c.kind, 0.0) + b
    return per, float(sum(per.values()))


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _positions(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Positions a sequence runs through the decoder stack in one step."""
    if shape.kind == "decode":
        return 1
    if shape.kind == "train" and cfg.family == "vlm":
        return shape.seq_len + cfg.frontend_tokens
    return shape.seq_len


def _uses(cfg: ModelConfig, path, leaf_shape, tail_len: int) -> int:
    """How many times a step applies a leaf's weight (one layer a use)."""
    keys = _dict_keys(path)
    if "shared" in keys and cfg.family == "hybrid":
        return n_shared_sites(cfg)
    return math.prod(leaf_shape[:len(leaf_shape) - tail_len])


def step_collectives(cfg: ModelConfig, shape: ShapeConfig, ax: MeshAxes,
                     params: Dict[Any, Any], pspecs: Dict[Any, P]
                     ) -> List[Collective]:
    """The collectives one step of the cell implies, from its placements.

    ``params`` / ``pspecs``: the ``{path: leaf}`` tree and its specs.
    ``ax`` is the cell's :class:`MeshAxes` (``as_pure_dp()`` under ZeRO).

    Tensor parallelism over ``model`` (each a partial sum, in
    ``layers.TP_PSUM_DTYPE``, over the tokens a device holds):

    * a product whose contraction dim is model-sharded (attention ``wo``,
      the MLP's and mamba's out-projections, the experts' ``w_down``, the
      combine) all-reduces its output in the forward pass; with remat the
      attention out-projection's sum runs again in the backward pass (the
      block's output itself is not recomputed);
    * a product whose output dim is model-sharded (``wq``/``wk``/``wv``,
      ``wi_gate``/``wi_up``, ``in_z``/``in_x``, the experts' dispatch)
      all-reduces its input's cotangent in the backward pass;
    * the vocab-sharded embedding's lookup all-reduces its rows (param
      dtype); the unembedding's input cotangent and the loss's three
      per-position statistics (max, sum, gold logit) all-reduce in fp32.

    Data parallelism: every gradient leaf all-reduces its shard over the
    dp axes the batch is split on; a leaf that FSDP or ZeRO shards over
    them is all-gathered before each use (forward, remat, backward) and
    its gradient reduce-scattered instead.

    Decode over a sequence-sharded cache: the query (and the new token's
    K and V, where their heads are model-sharded) gathered over ``model``,
    then the merge: two fp32 statistics ``[B, KV, G, 1]`` and the fp32
    numerator ``[B, KV, D, G, 1]`` all-reduced over the cache's sequence
    axes, each attention layer.  A prefill whose cache shards the sequence
    over ``model`` while K/V heads shard there too re-lays K and V out with
    an all-to-all a layer.
    """
    out: List[Collective] = []
    m = ax.model
    M = ax.model_size if m else 1
    dp = _dp_for(shape.global_batch, ax) or ()
    D = ax.axis_size(dp) if dp else 1
    B_loc = shape.global_batch // D
    pos = _positions(cfg, shape)
    T = B_loc * pos
    T_enc = B_loc * cfg.frontend_tokens
    # tokens the embedding looks up (a vlm prompt shrinks by its prefix)
    looked_up = B_loc * (1 if shape.kind == "decode" else shape.seq_len - (
        cfg.frontend_tokens if cfg.family == "vlm" and shape.kind == "prefill"
        else 0))
    leaf_names = {_dict_keys(p)[-1] for p in params}
    head = "unembed" if "unembed" in leaf_names else "embed"
    train = shape.kind == "train"
    remat = train and cfg.remat
    psum = L.TP_PSUM_DTYPE
    f32 = torch.float32

    def is_m(entry) -> bool:
        return m is not None and m in _axes_of(entry)

    def add(kind, shp, dtype, axes, count, what):
        g = ax.axis_size(tuple(axes)) if axes else 1
        if count and g > 1 and math.prod(shp):
            out.append(Collective(kind, tuple(int(s) for s in shp), dtype, g,
                                  int(count), what))

    def tokens_for(path, role: str) -> int:
        keys = _dict_keys(path)
        if "enc_blocks" in keys:
            return 0 if shape.kind == "decode" else T_enc
        if "cross_attn" in keys and role == "kv":
            return 0 if shape.kind == "decode" else T_enc
        return T

    for path, leaf in params.items():
        spec = tuple(pspecs[path]) + (None,) * (len(leaf.shape) - len(pspecs[path]))
        keys = _dict_keys(path)
        name = keys[-1] if keys else ""
        shp = tuple(leaf.shape)
        dtype = leaf.parts[0].dtype if hasattr(leaf, "parts") else leaf.dtype
        label = "/".join(str(k) for k in path)
        # -- tensor parallelism --
        if m is not None and M > 1:
            if name == "wo" and _looks_like_attn_wo(cfg, shp) and is_m(spec[-3]):
                n = _uses(cfg, path, shp, 3)
                t = tokens_for(path, "q")
                add("all-reduce", (t, shp[-1]), psum, (m,),
                    n * (2 if remat else 1), f"{label} partial sum")
            elif name in ("wo", "out_proj", "w_down") and is_m(
                    spec[-3] if name == "w_down" else spec[-2]):
                n = _uses(cfg, path, shp, 3 if name == "w_down" else 2)
                add("all-reduce", (tokens_for(path, "q"), shp[-1]), psum, (m,),
                    n, f"{label} partial sum")
            if train:
                if name in ("wq", "wk", "wv") and is_m(spec[-2]):
                    n = _uses(cfg, path, shp, 3)
                    role = "q" if name == "wq" else "kv"
                    add("all-reduce", (tokens_for(path, role), shp[-3]), f32,
                        (m,), n, f"{label} input cotangent")
                elif name in ("wi_gate", "wi_up", "in_z", "in_x") and is_m(spec[-1]):
                    n = _uses(cfg, path, shp, 2)
                    add("all-reduce", (tokens_for(path, "q"), shp[-2]), f32,
                        (m,), n, f"{label} input cotangent")
                elif name == "w_gate" and is_m(spec[-3]):
                    n = _uses(cfg, path, shp, 3)
                    add("all-reduce", (T, shp[-2]), f32, (m,), n,
                        f"{label} dispatch cotangent")
            if name == "embed" and is_m(spec[0]):
                add("all-reduce", (looked_up, shp[-1]), dtype, (m,), 1,
                    "embedding lookup")
            if train and name == head and is_m(spec[0]):
                add("all-reduce", (T, shp[-1]), f32, (m,), 1,
                    "unembedding input cotangent")
                add("all-reduce", (B_loc, shape.seq_len - 1), f32, (m,), 3,
                    "loss statistics over the vocab")
        # -- data parallelism --
        gathered = tuple(a for e in spec for a in _axes_of(e) if a in ax.dp)
        shard = list(shp)
        for i, e in enumerate(spec):
            ways = ax.axis_size(_axes_of(e)) if _axes_of(e) else 1
            shard[i] = -(-shard[i] // ways)
        if gathered:
            full = list(shard)
            for i, e in enumerate(spec):
                g = [a for a in _axes_of(e) if a in gathered]
                if g:
                    full[i] *= ax.axis_size(tuple(g))
            uses = 1 + int(train) + int(remat)  # forward, backward, remat
            add("all-gather", full, dtype, gathered, uses, f"{label} gather")
        if train and dp:
            red = tuple(a for a in dp if a not in gathered)
            if gathered:
                add("reduce-scatter", shard, dtype, gathered, 1,
                    f"{label} gradient")
            add("all-reduce", shard, dtype, red, 1, f"{label} gradient")

    # -- decode over a sequence-sharded cache / prefill's re-layout --
    if shape.kind in ("decode", "prefill") and cfg.family != "ssm":
        kv_heads = cfg.eff_kv_heads
        G = cfg.eff_heads // max(1, kv_heads)
        dh = cfg.d_head
        wq = next((pspecs[p] for p in params if _dict_keys(p)[-1] == "wq"), None)
        wk = next((pspecs[p] for p in params if _dict_keys(p)[-1] == "wk"), None)
        q_m = wq is not None and is_m(tuple(wq)[-2])
        k_m = wk is not None and is_m(tuple(wk)[-2])
        # the cache's sequence axes, as ``cache_pspecs`` shards them
        seq_axes = tuple(a for a in ax.dp if a not in dp) + ((m,) if m else ())
        for name, n_sites, seq in _attention_sites(cfg, shape):
            s_axes = _divisible_prefix(seq_axes, seq, ax)
            if shape.kind == "prefill":
                if k_m and m in s_axes and name == "self":
                    add("all-to-all", (B_loc, kv_heads, seq // ax.axis_size(s_axes), dh),
                        torch.bfloat16, (m,), 2 * n_sites, "K/V re-layout")
                continue
            if q_m:
                add("all-gather", (B_loc, 1, cfg.eff_heads, dh), torch.bfloat16,
                    (m,), n_sites, f"{name}-attention query gather")
            if k_m and name == "self":
                add("all-gather", (B_loc, kv_heads, 1, dh), torch.bfloat16, (m,),
                    2 * n_sites, "new K/V gather")
            add("all-reduce", (B_loc, kv_heads, G, 1), f32, s_axes, 2 * n_sites,
                f"{name}-attention max and sum")
            add("all-reduce", (B_loc, kv_heads, dh, G, 1), f32, s_axes, n_sites,
                f"{name}-attention numerator")
    return out


def _attention_sites(cfg: ModelConfig, shape: ShapeConfig):
    """``(kind, sites, cache length)`` of the attention a decode step runs."""
    S = shape.seq_len
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        return [("self", cfg.n_layers, S)]
    if fam == "hybrid":
        return [("self", n_shared_sites(cfg), S)]
    if fam == "encdec":
        return [("self", cfg.n_layers, S),
                ("cross", cfg.n_layers, cfg.frontend_tokens)]
    return []


# ---------------------------------------------------------------------------
# analytic minimal HBM traffic (roofline memory term)
# ---------------------------------------------------------------------------


def analytic_hbm_bytes(
    *, param_bytes_dev: float, opt_bytes_dev: float, stash_bytes_dev: float,
    cache_bytes_dev: float, io_bytes_dev: float, kind: str,
) -> float:
    """Minimum HBM movement per step per device for a perfectly-fused program.

    train:   params read (fwd+bwd) + grads written+read + opt r/w + stash w+r
    prefill: params read + cache written + io
    decode:  params read + cache read(+append) + io
    """
    if kind == "train":
        return (3 * param_bytes_dev          # fwd read + bwd read + write back
                + 2 * param_bytes_dev        # grads write + read
                + 2 * opt_bytes_dev          # opt states read + write
                + 2 * stash_bytes_dev        # stash write + re-read
                + io_bytes_dev)
    if kind == "prefill":
        return param_bytes_dev + cache_bytes_dev + 2 * stash_bytes_dev + io_bytes_dev
    return param_bytes_dev + cache_bytes_dev + io_bytes_dev
