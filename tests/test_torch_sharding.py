"""The port's placement rules (``repro_torch.distributed.sharding``, the
optimizers' ``state_pspecs``) against the JAX package's, spec for spec.

For every arch at full width, on meshes ``(16, 16)`` and ``(2, 4)``
``("data", "model")``, ``(2, 16, 16)`` ``("pod", "data", "model")`` and
``(1, 1)``: ``param_pspecs`` (FSDP off and on, strategies ``"tp"`` and
``"zero"``), ``batch_pspecs`` of every shape, ``cache_pspecs`` of both
decode shapes and both optimizers' ``state_pspecs`` equal the
reference's.  The reference side is built as ``tests/test_sharding.py``
builds it, with ``jax.eval_shape`` and an ``AbstractMesh``; the port's on
``meta``.  The hybrid family's cache is the port's own layout, so its
leaves are compared through the mapping ``HYBRID_CACHE`` below, each
port leaf's spec against its reference counterparts' with the stacking
dims left aside (every such dim is ``None`` on both sides).  Last,
``Placement.shard_shape`` / ``shard_bytes`` on indivisible and multi-axis
specs.
"""

import functools

import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as JP  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.launch.mesh import MeshAxes as RefMeshAxes  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.sharding import P, Placement, placements  # noqa: E402
from repro_torch.launch.mesh import MeshAxes, make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.param_tree import flatten  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402

MESHES = (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")), ((1, 1), ("data", "model")))

# the hybrid cache: port leaf -> its reference counterparts (the shared
# block's sites stack the reference's ``kv`` groups then its tail; the
# mamba layers stack ``states`` then ``tail_state``)
HYBRID_CACHE = {
    ("k",): [("kv", 0), ("tail_kv", 0)],
    ("v",): [("kv", 1), ("tail_kv", 1)],
    ("conv", "x"): [("states", 0, "x"), ("tail_state", 0, "x")],
    ("conv", "B"): [("states", 0, "B"), ("tail_state", 0, "B")],
    ("conv", "C"): [("states", 0, "C"), ("tail_state", 0, "C")],
    ("ssm",): [("states", 1), ("tail_state", 1)],
    ("length",): [("length",)],
}
# the dims a cache leaf's rule places (the rest stack sites or layers)
TRAILING = {"k": 4, "v": 4, "ssm": 4, "x": 3, "B": 3, "C": 3, "length": 0}


def _ref_mesh(shape, axes):
    try:  # jax >= 0.4.36: AbstractMesh(((name, size), ...))
        return AbstractMesh(tuple(zip(axes, shape)))
    except TypeError:
        return AbstractMesh(shape, axes)


def _key(k):
    if hasattr(k, "key"):
        return str(k.key)
    if hasattr(k, "idx"):
        return k.idx
    raise TypeError(k)


def ref_flat(tree, with_leaves=False):
    """``{path: tuple(spec)}`` of a reference spec tree (or its leaves)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(_key(k) for k in path): (leaf if with_leaves else tuple(leaf))
            for path, leaf in leaves}


def _walk(tree, prefix=()):
    """``(path, spec)`` of a port spec tree; a dict keyed by path tuples
    (``param_pspecs``'s) spreads its keys into the path."""
    if isinstance(tree, P):
        yield prefix, tuple(tree)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (tuple(k) if isinstance(k, tuple) else (k,)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (i,))


@functools.lru_cache(maxsize=None)
def models(arch):
    rcfg, pcfg = ref_get_config(arch), get_config(arch)
    rmodel = ref_registry.get_model(rcfg)
    rshape = jax.eval_shape(rmodel.init, jax.random.key(0))
    pmodel = registry.abstract_params(pcfg)
    api = registry.get_model(pcfg, attn_backend="dense-ref")
    return rcfg, pcfg, rshape, api.ref_leaves(pmodel)


def _sched(step):
    return 1e-3


@pytest.mark.parametrize("mesh_shape,axes", MESHES,
                         ids=["x".join(map(str, m)) for m, _ in MESHES])
@pytest.mark.parametrize("arch", list_archs())
def test_specs_equal_the_references(arch, mesh_shape, axes):
    rcfg, pcfg, rshape, leaves = models(arch)
    rax = RefMeshAxes(_ref_mesh(mesh_shape, axes))
    n = 1
    for s in mesh_shape:
        n *= s
    pax = MeshAxes(make_mesh(mesh_shape, axes, ["meta"] * n))
    assert set(ref_flat(rshape, with_leaves=True)) == set(leaves)

    # params: FSDP off and on, tp and zero
    for fsdp in (False, True):
        for strategy in ("tp", "zero"):
            want = ref_flat(ref_sharding.param_pspecs(
                rcfg, rshape, rax, fsdp=fsdp, strategy=strategy))
            got = sharding.param_pspecs(pcfg, leaves, pax, fsdp=fsdp,
                                        strategy=strategy)
            assert {k: tuple(v) for k, v in got.items()} == want, (fsdp, strategy)

    # optimizer states over the tp specs (FSDP as the dry run picks it)
    fsdp = pcfg.param_count() * 2 > 8e9
    rspecs = ref_sharding.param_pspecs(rcfg, rshape, rax, fsdp=fsdp)
    pspecs = sharding.param_pspecs(pcfg, leaves, pax, fsdp=fsdp)
    for ref_cls, cls in ((ref_opt.AdamW, optimizer.AdamW),
                         (ref_opt.Adafactor, optimizer.Adafactor)):
        want = ref_flat(ref_cls(schedule=_sched).state_pspecs(rspecs, rshape))
        got = dict(_walk(cls(schedule=_sched).state_pspecs(pspecs, leaves)))
        assert got == want, cls.__name__

    # batches of every shape
    for name in SHAPES:
        rb = ref_registry.input_specs(rcfg, REF_SHAPES[name], abstract=True)
        pb = registry.input_specs(pcfg, SHAPES[name], abstract=True)
        want = ref_flat(ref_sharding.batch_pspecs(rcfg, REF_SHAPES[name], rb, rax))
        got = dict(_walk(sharding.batch_pspecs(pcfg, SHAPES[name], pb, pax)))
        assert got == want, name

    # decode caches
    for name in ("decode_32k", "long_500k"):
        rc = ref_registry.cache_specs(rcfg, REF_SHAPES[name], abstract=True)
        pc = registry.cache_specs(pcfg, SHAPES[name], abstract=True)
        want = ref_flat(ref_sharding.cache_pspecs(rcfg, REF_SHAPES[name], rc, rax))
        got = dict(_walk(sharding.cache_pspecs(pcfg, SHAPES[name], pc, pax)))
        if pcfg.family != "hybrid":
            assert got == want, name
            continue
        ref_nd = {k: len(v.shape) for k, v in ref_flat(rc, True).items()}
        port_nd = {k: len(v.shape) for k, v in flatten(pc).items()}
        assert set(got) == set(HYBRID_CACHE)
        for port_key, ref_keys in HYBRID_CACHE.items():
            ref_keys = [k for k in ref_keys if k in want]
            assert ref_keys, port_key
            lead = port_nd[port_key] - TRAILING[port_key[-1]]
            spec = got[port_key]
            assert all(s is None for s in spec[:lead])
            for rk in ref_keys:
                rlead = ref_nd[rk] - port_nd[port_key] + lead
                assert all(s is None for s in want[rk][:rlead]), rk
                assert want[rk][rlead:] == spec[lead:], (name, port_key, rk)


def test_placement_shard_shape():
    mesh = make_mesh((2, 4), ("data", "model"), ["meta"] * 8)
    pl = Placement(mesh, P(("data", "model"), None, "model"))
    assert pl.ways(0) == 8 and pl.ways(1) == 1 and pl.ways(2) == 4
    assert pl.shard_shape((64, 3, 10)) == (8, 3, 3)   # 10 over 4: padded to 12
    assert pl.shard_bytes((64, 3, 10), torch.bfloat16) == 8 * 3 * 3 * 2
    # a spec shorter than the leaf replicates the trailing dims
    assert Placement(mesh, P("data")).shard_shape((6, 5, 7)) == (3, 5, 7)
    assert Placement(mesh, P()).shard_bytes((), torch.int32) == 4
    # placements keep the spec tree's structure
    tree = placements(mesh, {"a": P(None, "model"), "b": [P(), P("data")]})
    assert tree["a"].spec == (None, "model") and tree["b"][1].ways(0) == 2
    prod = make_production_mesh(multi_pod=True)
    assert prod.shape == {"pod": 2, "data": 16, "model": 16}
    assert {d.type for d in prod.flat()} == {"meta"}
    assert MeshAxes(prod).dp == ("pod", "data") and MeshAxes(prod).model_size == 16
    assert Placement(prod, P(("pod", "data"), "model")).shard_shape(
        (128, 32768)) == (4, 2048)
