"""Sharding rules: params, batches and caches → partition specs.

The reference's placement rules, over the port's trees.  A spec (:class:`P`)
names, for each dim of a leaf, the mesh axis (or tuple of axes, composed
row-major) it is split over, or ``None``; it compares equal to the tuple of
a JAX ``PartitionSpec``.  Parameter rules are *name + trailing-dims* based:
each parameter name maps to a spec for its trailing semantic dims, and any
extra leading dims (the stacked-layer axis, zamba's ``[group, layer]``
axes) get ``None``, so one table covers every family.

Policies:

* weights: TP over ``model`` (heads / ffn / experts / ssd-heads); optional
  FSDP shards the non-TP dim over ``data`` (the dry run turns it on for the
  models whose bf16 params exceed ~8 GB);
* GQA with ``n_kv_heads`` not divisible by the model axis: KV projections
  stay replicated on the head dim (they are small); scores still shard
  over Q heads;
* train/prefill activations: batch over ``(pod, data)``;
* decode KV cache: batch over the dp axes when divisible, **sequence over
  model** (split-KV decode); long_500k (batch 1) puts the sequence over
  ``(data, model)``.

The trees: parameters are ``{path: RefLeaf}`` (``models/param_tree.py``,
the reference's leaf paths and stacked shapes); batches and caches are the
nested dicts (and lists) of ``registry.input_specs`` and
``registry.cache_specs``, or a prefill's returned cache.  The hybrid
family's cache is the port's own layout (``{"k", "v", "conv", "ssm"}``
stacked over sites and layers); each leaf gets the spec the reference
gives its counterpart in ``kv`` / ``tail_kv`` / ``states`` /
``tail_state``, leading dims aside.

:func:`placements` is the counterpart of the reference's ``to_named``: a
tree of :class:`Placement` (mesh + spec), which gives a leaf's shard shape
and bytes on one device; the dry run reads placements only to count bytes
and collectives.  :func:`place` moves a real tensor onto a placement, as
``jax.device_put(x, NamedSharding(mesh, spec))`` does: a :class:`Sharded`
holds one :class:`Shard` a mesh entry, in the mesh's row-major order,
each a contiguous copy of its block of the whole leaf on its entry's
device (the list of shards a leaf of ``launch/mesh.py``, over a mesh of
several axes).  :func:`gather` puts the whole leaf back together on one
device, and :func:`place_tree` places a tree leaf by leaf.  The port runs
its models on whole tensors; placed leaves are what a restore onto a mesh
(``training/checkpoint.py``) and a sharded batch (``data/pipeline.py``)
hand over.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import Mesh, MeshAxes
from repro_torch.models.param_tree import Path, RefLeaf

__all__ = ["P", "Placement", "Shard", "Sharded", "param_pspecs",
           "zero_param_pspecs", "batch_pspecs", "cache_pspecs", "placements",
           "place", "gather", "place_tree", "map_tree", "tree_leaves"]

Tree = Any


class P(tuple):
    """A partition spec: one entry a dim, each ``None``, an axis name or a
    tuple of axis names; trailing dims past its length are replicated.  A
    tuple of one name is that name, as in a JAX ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def map_tree(fn: Callable[[Path, Any], Any], tree: Tree,
             is_leaf: Callable[[Any], bool] = lambda x: False,
             path: Path = ()) -> Tree:
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; ``None``
    stays ``None`` (no leaves, as in a JAX pytree).  A dict key and a list
    index each add one entry to the path (an index as an int)."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, Mapping):
        return {k: map_tree(fn, v, is_leaf, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, is_leaf, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree: Tree, is_leaf: Callable[[Any], bool] = lambda x: False
                ) -> list:
    out: list = []
    map_tree(lambda _, x: out.append(x), tree, is_leaf)
    return out


def _dict_keys(path: Path) -> list:
    return [str(k) for k in path if isinstance(k, str)]


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def _tail_rules(cfg: ModelConfig, ax: MeshAxes, fsdp: bool) -> Dict[str, tuple]:
    """name → trailing-dims spec (entries may be None / axis name / tuple)."""
    m = ax.model
    f = ax.dp if (fsdp and ax.dp) else None
    kv_ok = m is not None and cfg.n_kv_heads and (
        cfg.eff_kv_heads % ax.model_size == 0)
    heads_ok = m is not None and cfg.n_heads and (
        cfg.eff_heads % ax.model_size == 0)
    hm = m if heads_ok else None
    km = m if kv_ok else None
    return {
        # attention
        "wq": (f, hm, None),
        "wk": (f, km, None),
        "wv": (f, km, None),
        "wo@3": (hm, None, f),          # attn out-proj [H, dh, D]
        "bq": (hm, None),
        "bk": (km, None),
        "bv": (km, None),
        # mlp
        "wi_gate": (f, m),
        "wi_up": (f, m),
        "wo@2": (m, f),                 # mlp out-proj [F, D]
        # embeddings (vocab-sharded)
        "embed": (m, f),
        "unembed": (m, f),
        # moe
        "router": (f, None),
        "w_gate": (m, f, None),
        "w_up": (m, f, None),
        "w_down": (m, None, f),
        # mamba2
        "in_z": (f, m),
        "in_x": (f, m),
        "in_B": (f, None),
        "in_C": (f, None),
        "in_dt": (f, None),
        "conv_x_w": (None, m),
        "conv_x_b": (m,),
        "conv_B_w": (None, None),
        "conv_B_b": (None,),
        "conv_C_w": (None, None),
        "conv_C_b": (None,),
        "A_log": (m,),
        "dt_bias": (m,),
        "D": (m,),
        "norm": (m,),                   # mamba RMSNorm over d_inner
        "out_proj": (m, f),
    }


def _looks_like_attn_wo(cfg: ModelConfig, shape) -> bool:
    if len(shape) < 3:
        return False
    _, dh, d = shape[-3:]
    return dh == cfg.d_head and d == cfg.d_model


def _drop_indivisible(spec, shape, ax: MeshAxes) -> tuple:
    out = []
    for s, dim in zip(spec, shape):
        if s is None:
            out.append(None)
            continue
        size = ax.axis_size(s)
        out.append(s if size and dim % size == 0 else None)
    return tuple(out)


def _divisible_prefix(axes: Tuple[str, ...], dim: int, ax: MeshAxes
                      ) -> Tuple[str, ...]:
    out: Tuple[str, ...] = ()
    prod = 1
    for a in axes:
        if dim % (prod * ax.axis_size(a)) == 0:
            out = out + (a,)
            prod *= ax.axis_size(a)
    return out


# leading dims of these subtrees stack layers; ZeRO never shards them (the
# reference's scan slices one layer a step, and a sharded layer axis would be
# re-gathered every iteration)
_STACKED_KEYS = {"blocks", "moe_blocks", "dense_blocks", "enc_blocks",
                 "dec_blocks", "tail"}


def zero_param_pspecs(cfg: ModelConfig, params: Mapping[Path, Any],
                      ax: MeshAxes) -> Dict[Path, P]:
    """ZeRO-3 / pure-DP strategy: the batch shards over *every* mesh axis
    and each parameter shards its largest divisible non-stacked dim over
    the whole mesh (or the longest divisible prefix of the axes), so a
    step's collective volume is O(params) instead of O(activations x
    layers).  Tensors whose dims are all under 1024 stay replicated."""
    all_axes = tuple(ax.dp) + ((ax.model,) if ax.model else ())

    def spec_for(path: Path, leaf) -> P:
        shape = tuple(leaf.shape)
        names = set(_dict_keys(path))
        skip = 0
        if names & _STACKED_KEYS:
            skip = 1
        if "groups" in names:       # zamba: [group, layer, ...]
            skip = 2
        if not shape or max(shape) < 1024:
            return P(*([None] * len(shape)))
        spec: list = [None] * len(shape)
        order = sorted(range(skip, len(shape)), key=lambda i: -shape[i])
        for i in order:
            keep = _divisible_prefix(all_axes, shape[i], ax)
            if keep and len(keep) == len(all_axes):
                spec[i] = keep if len(keep) > 1 else keep[0]
                break
        else:
            for i in order:
                keep = _divisible_prefix(all_axes, shape[i], ax)
                if keep:
                    spec[i] = keep if len(keep) > 1 else keep[0]
                    break
        return P(*spec)

    return {path: spec_for(path, leaf) for path, leaf in params.items()}


def param_pspecs(cfg: ModelConfig, params: Mapping[Path, Any], ax: MeshAxes,
                 fsdp: bool = False, strategy: str = "tp") -> Dict[Path, P]:
    """``{path: P}`` over ``params`` (``{path: leaf}``, any leaf with a
    ``shape``: a :class:`~repro_torch.models.param_tree.RefLeaf`).

    ``strategy="tp"``: tensor parallelism over ``model`` (+ optional FSDP
    on the non-TP dim); ``strategy="zero"``: ZeRO-3 pure DP
    (:func:`zero_param_pspecs`).  SSD heads shard over ``model`` only where
    it divides them; a mesh without the axis replicates everything."""
    if strategy == "zero":
        return zero_param_pspecs(cfg, params, ax)
    rules = _tail_rules(cfg, ax, fsdp)
    mamba_head_ok = ax.model is None or not cfg.ssm_heads or (
        cfg.ssm_heads % ax.model_size == 0)
    inner_ok = ax.model is None or not cfg.ssm_heads or (
        cfg.d_inner % ax.model_size == 0)

    def spec_for(path: Path, leaf) -> P:
        keys = _dict_keys(path)
        name = keys[-1] if keys else ""
        shape = tuple(leaf.shape)
        ndim = len(shape)
        key = name
        if name == "wo":
            # attn wo's trailing dims are [H, dh, D]; mlp wo's [F, D]
            key = "wo@3" if _looks_like_attn_wo(cfg, shape) else "wo@2"
        tail = rules.get(key)
        if tail is None:
            return P()
        if name in ("A_log", "dt_bias", "D") and not mamba_head_ok:
            tail = (None,) * len(tail)
        if name in ("in_z", "in_x", "conv_x_w", "conv_x_b", "norm",
                    "out_proj") and not inner_ok:
            tail = tuple(a if a != ax.model else None for a in tail)
        if len(tail) > ndim:
            tail = tail[-ndim:]
        spec = (None,) * (ndim - len(tail)) + tuple(tail)
        return P(*_drop_indivisible(spec, shape, ax))

    return {path: spec_for(path, leaf) for path, leaf in params.items()}


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------


def _dp_for(batch: int, ax: MeshAxes) -> Optional[Tuple[str, ...]]:
    """Largest prefix of dp axes whose product divides the batch."""
    dims: Tuple[str, ...] = ()
    prod = 1
    for a in ax.dp:
        if batch % (prod * ax.axis_size(a)) == 0:
            dims = dims + (a,)
            prod *= ax.axis_size(a)
    return dims if dims else None


def _is_array(x) -> bool:
    return isinstance(x, torch.Tensor) or hasattr(x, "shape")


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, batch: Tree,
                 ax: MeshAxes) -> Tree:
    """Every batch leaf: its first dim over the dp axes that divide the
    global batch."""
    dp = _dp_for(shape.global_batch, ax)
    return map_tree(lambda _, leaf: P(dp, *([None] * (len(leaf.shape) - 1))),
                    batch, _is_array)


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig, cache: Tree,
                 ax: MeshAxes) -> Tree:
    """Decode-cache specs, leaf by leaf.

    KV arrays ``[..., B, KV, S, dh]``: B → dp, S → model (+ the dp axes the
    batch leaves free, when B is 1): the split-KV decode sharding.  SSM
    states ``[..., B, H, P, N]``: H → model when divisible.  Conv tails
    ``[..., B, K-1, C]``: C → model when divisible."""
    B = shape.global_batch
    dp = _dp_for(B, ax)
    used = set(dp or ())
    free_dp = tuple(a for a in ax.dp if a not in used)
    seq_axes = free_dp + ((ax.model,) if ax.model else ())

    def kv_spec(leaf) -> P:
        lead = len(leaf.shape) - 4
        seq = _divisible_prefix(seq_axes, leaf.shape[-2], ax)
        return P(*([None] * lead), dp, None, seq if seq else None, None)

    def ssm_spec(leaf) -> P:
        lead = len(leaf.shape) - 4
        h = leaf.shape[-3]
        m = ax.model if ax.model and h % ax.model_size == 0 else None
        return P(*([None] * lead), dp, m, None, None)

    def conv_spec(leaf) -> P:
        lead = len(leaf.shape) - 3
        c = leaf.shape[-1]
        m = ax.model if ax.model and c % ax.model_size == 0 else None
        return P(*([None] * lead), dp, None, m)

    def spec_for(path: Path, leaf) -> P:
        if len(leaf.shape) == 0:
            return P()
        names = _dict_keys(path)
        name = names[-1] if names else ""
        ndim = len(leaf.shape)
        if name in ("k", "v", "kc", "vc") or (
                "kv" in names and ndim >= 4) or ("tail_kv" in names and ndim >= 4):
            return kv_spec(leaf)
        if name == "ssm" or ("states" in names and ndim >= 4
                             and leaf.shape[-1] == cfg.ssm_state):
            return ssm_spec(leaf)
        if name in ("x", "B", "C") or "conv" in names:
            return conv_spec(leaf)
        if "tail_state" in names:
            return (ssm_spec(leaf) if leaf.shape[-1] == cfg.ssm_state
                    else conv_spec(leaf))
        return P()

    return map_tree(spec_for, cache, _is_array)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Placement:
    """A leaf's place on a mesh: ``spec`` over ``mesh``'s axes."""

    mesh: Mesh
    spec: P

    def _axes(self, dim: int) -> Tuple[str, ...]:
        if dim >= len(self.spec) or self.spec[dim] is None:
            return ()
        names = self.spec[dim]
        return names if isinstance(names, tuple) else (names,)

    def ways(self, dim: int) -> int:
        """How many shards dim ``dim`` is cut into."""
        return math.prod(self.mesh.shape[n] for n in self._axes(dim))

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """One device's shard of a leaf of ``shape`` (a dim its axes do not
        divide is padded up to the next multiple, as an uneven split is)."""
        return tuple(-(-int(n) // self.ways(i)) for i, n in enumerate(shape))

    def shard_bytes(self, shape, dtype: torch.dtype) -> int:
        item = torch.empty((), dtype=dtype).element_size()
        return math.prod(self.shard_shape(shape)) * item

    def index(self, shape, entry: int) -> Tuple[slice, ...]:
        """The block of a leaf of ``shape`` that mesh entry ``entry`` (row-
        major, as ``mesh.flat()``) holds: dim ``i`` cut into ``ways(i)``
        equal blocks, the entry's coordinates along the dim's axes composed
        row-major; a dim that names no axis whole.  Raises where the spec
        is longer than the leaf's rank, names an axis the mesh lacks, or
        a dim's axes do not divide it (as ``jax.device_put`` does)."""
        shape = tuple(int(n) for n in shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} is longer than the rank of a "
                             f"leaf of shape {shape}")
        sizes = self.mesh.shape
        for i in range(len(shape)):
            for name in self._axes(i):
                if name not in sizes:
                    raise ValueError(f"spec {self.spec} names axis {name!r}, "
                                     f"which the mesh {tuple(sizes)} lacks")
        coords = dict(zip(self.mesh.axis_names,
                          np.unravel_index(entry, self.mesh.devices.shape)))
        out = []
        for i, n in enumerate(shape):
            ways = self.ways(i)
            if n % ways:
                raise ValueError(f"dim {i} of a leaf of shape {shape} is not "
                                 f"divisible by the {ways} ways of spec "
                                 f"{self.spec} on mesh {sizes}")
            block = 0
            for name in self._axes(i):
                block = block * sizes[name] + int(coords[name])
            size = n // ways
            out.append(slice(block * size, (block + 1) * size))
        return tuple(out)


def placements(mesh: Mesh, spec_tree: Tree) -> Tree:
    """The counterpart of the reference's ``to_named``: each :class:`P` of
    ``spec_tree`` becomes a :class:`Placement` on ``mesh`` (a dict keyed by
    paths, as :func:`param_pspecs` returns, keeps its keys)."""
    return map_tree(lambda _, s: Placement(mesh, s), spec_tree,
                    lambda x: isinstance(x, P))


# ---------------------------------------------------------------------------
# real tensors on placements
# ---------------------------------------------------------------------------


def _bounds(index: Tuple[slice, ...]) -> Tuple[Tuple[int, int], ...]:
    return tuple((s.start, s.stop) for s in index)


@dataclasses.dataclass(frozen=True)
class Shard:
    """One mesh entry's part of a placed leaf: ``data``, on the entry's
    device, holds ``whole[index]`` (``index`` a slice a dim, with its
    bounds)."""

    index: Tuple[slice, ...]
    data: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A leaf of ``shape`` and ``dtype`` placed on ``placement``: shard ``n``
    lives on ``placement.mesh.flat()[n]``."""

    placement: Placement
    shape: Tuple[int, ...]
    dtype: torch.dtype
    shards: Tuple[Shard, ...]

    @property
    def blocks(self) -> int:
        """How many distinct blocks the leaf is cut into (1: replicated)."""
        return math.prod(self.placement.ways(i) for i in range(len(self.shape)))


def place(x, placement: Placement) -> Sharded:
    """``x`` (a tensor, a numpy array or a :class:`RefLeaf`, placed by its
    stacked value) on ``placement``, as ``jax.device_put(x,
    NamedSharding(mesh, spec))``: each shard a contiguous copy of its
    block (:meth:`Placement.index`) on its entry's device, its bytes the
    leaf's.  A mesh may name one device more than once (a test layout);
    an entry then shares the tensor of an earlier entry that holds the
    same block on the same device (a replica), since a copy there buys
    nothing."""
    if isinstance(x, RefLeaf):
        x = x.stacked()
    x = torch.as_tensor(x).detach()
    copies: Dict[tuple, torch.Tensor] = {}
    shards: List[Shard] = []
    for n, dev in enumerate(placement.mesh.flat()):
        index = placement.index(x.shape, n)
        key = (dev, _bounds(index))
        if key not in copies:
            copies[key] = x[index].to(dev, copy=True,
                                      memory_format=torch.contiguous_format)
        shards.append(Shard(index, copies[key]))
    return Sharded(placement, tuple(x.shape), x.dtype, tuple(shards))


def gather(sharded: Sharded, device) -> torch.Tensor:
    """The whole leaf on ``device``, each block copied once from the first
    shard that holds it."""
    out = torch.empty(sharded.shape, dtype=sharded.dtype, device=device)
    done = set()
    for shard in sharded.shards:
        key = _bounds(shard.index)
        if key not in done:
            done.add(key)
            out[shard.index] = shard.data.to(out.device)
    return out


def place_tree(tree: Tree, placement_tree: Tree) -> Tree:
    """:func:`place` leaf by leaf over ``tree``, whose structure
    ``placement_tree`` shares (dicts by key, lists and tuples by
    position); a ``None`` in ``placement_tree`` leaves its leaf, or its
    whole subtree, as it is."""
    if placement_tree is None:
        return tree
    if isinstance(placement_tree, Placement):
        return place(tree, placement_tree)
    if isinstance(placement_tree, Mapping):
        return {k: place_tree(v, placement_tree[k]) for k, v in tree.items()}
    if isinstance(placement_tree, (list, tuple)):
        return type(tree)(place_tree(v, p)
                          for v, p in zip(tree, placement_tree, strict=True))
    raise TypeError(f"a placement tree holds Placements, None, dicts, lists "
                    f"and tuples, not {type(placement_tree).__name__}")
