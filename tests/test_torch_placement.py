"""Real tensors on placements (``distributed/sharding.py``: ``place``,
``gather``, ``place_tree``), the elastic restore
(``training/checkpoint.restore(..., shardings=)``), sharded batches
(``data/pipeline.PipelineSpec.device_batch(shardings=)``) and the int8
all-reduce (``distributed/compression.compressed_psum``) against the JAX
package's, on the CPU, bit for bit.

One subprocess runs the reference on 8 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_fault_tolerance.py``'s resharding and psum tests do) and
reports every shard of every leaf by its position in the mesh (row-major
over ``mesh.devices``): its index (each dim's bounds), dtype, shape and a
SHA-256 of its bytes.  The port's meshes are of the CPU
(``make_mesh(shape, axes, ["cpu"] * 8)``), whose shard ``n`` is the
reference's at the same position.

* (i) ``place`` against ``jax.device_put(leaf, NamedSharding(mesh,
  spec))`` for reduced llama3.2-1b's (bf16) and deepseek-moe-16b's (fp32)
  parameters under ``param_pspecs`` (FSDP off and on), drawn from a seed,
  on ``(2, 4)`` and ``(1, 8)`` ``("data", "model")`` and ``(8,)``
  ``("data",)``; the port places the stacked value of each ``RefLeaf``.
* (ii) a checkpoint the port's ``Trainer`` wrote on the CPU (reduced
  llama3.2-1b, 2 steps) restored by the reference with a whole
  ``shardings`` tree (params and AdamW's state) on ``(2, 4)``, and by the
  port with ``shardings=placements(...)``; ``gather`` equals the unsharded
  restore, a ``None`` leaf or subtree is written in place, and at least
  one leaf is split (the reference test's ``n_sharded > 0``).
* (iii) ``device_batch(step, shardings=)`` against the reference's with
  ``to_named(mesh, batch_pspecs(...))``.
* (iv) ``compressed_psum`` over 8 shards of one seeded ``(8, 64, 64)``
  fp32 array against the reference's under ``shard_map_compat``, and
  within the reference's ``8 x scale`` of the fp32 sum.
* (v) ``place`` raises on a dim its axes do not divide; (vi)
  ``device_batch`` raises without a card unless ``device="cpu"``.
"""

import hashlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.data.pipeline import PipelineSpec  # noqa: E402
from repro_torch.distributed.compression import compressed_psum  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    P,
    Placement,
    Sharded,
    batch_pspecs,
    gather,
    param_pspecs,
    place,
    place_tree,
    placements,
)
from repro_torch.launch.mesh import MeshAxes, make_mesh  # noqa: E402
from repro_torch.models import moe, registry, transformer  # noqa: E402
from repro_torch.models.param_tree import RefLeaf, flatten, nest  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.trainer import Trainer, TrainerConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x4": ((2, 4), ("data", "model")), "1x8": ((1, 8), ("data", "model")),
          "8": ((8,), ("data",))}
# the parameters of (i): arch -> (its family's params_from_arrays, dtype)
PARAM_ARCHS = {"llama3.2-1b": (transformer.params_from_arrays, torch.bfloat16),
               "deepseek-moe-16b": (moe.params_from_arrays, torch.float32)}
PARAM_SEED = 7
TRAIN_SHAPE = dict(seq_len=16, global_batch=4)
BATCH_SHAPE = dict(seq_len=16, global_batch=8)
BATCH_CASES = (("llama3.2-1b", "2x4"), ("llama3.2-1b", "1x8"),
               ("llama3.2-1b", "8"), ("internvl2-2b", "2x4"),
               ("seamless-m4t-medium", "2x4"))
BATCH_STEP, PIPE_SEED = 5, 3
# specs that compose axes on one dim, in both orders, on a (16, 8) leaf
COMPOSED = ([["data", "model"]], [["model", "data"]], ["model", "data"],
            [None, ["data", "model"]], ["data"], [["model", "data"], None])
PSUM_SHAPE, PSUM_SEED = (8, 64, 64), 0

REFERENCE = textwrap.dedent("""
    import hashlib, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, ml_dtypes, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import ShapeConfig, get_config
    from repro.data.pipeline import PipelineSpec
    from repro.distributed.compression import compressed_psum
    from repro.distributed.sharding import (
        batch_pspecs, param_pspecs, shard_map_compat, to_named)
    from repro.launch.mesh import MeshAxes, make_mesh
    from repro.models.registry import get_model
    from repro.training import checkpoint as ckpt
    from repro.training.optimizer import get_optimizer

    job = json.load(open(sys.argv[1]))
    out = {"place": {}, "batch": {}}

    def key_of(path):
        return "__".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path)

    def shards(arr, mesh):
        pos = {d.id: n for n, d in enumerate(mesh.devices.reshape(-1))}
        got = {}
        for s in arr.addressable_shards:
            data = np.asarray(s.data)
            index = [[sl.start or 0, n if sl.stop is None else sl.stop]
                     for sl, n in zip(s.index, arr.shape)]
            got[pos[s.device.id]] = dict(
                index=index, dtype=str(data.dtype), shape=list(data.shape),
                sha=hashlib.sha256(
                    np.ascontiguousarray(data).tobytes()).hexdigest())
        return [got[n] for n in range(mesh.size)]

    def report(tree, mesh):
        return {key_of(p): shards(a, mesh)
                for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}

    def mesh_of(name):
        shape, axes = job["meshes"][name]
        return make_mesh(tuple(shape), tuple(axes))

    # (i) params from the port's bits under the reference's own specs
    for arch, path in job["params"].items():
        cfg = get_config(arch).reduced()
        model = get_model(cfg)
        shapes = jax.eval_shape(model.init, jax.random.key(0))
        npz = np.load(path)
        dtypes = json.loads(str(npz["__dtypes__"]))
        for name in job["meshes"]:
            mesh = mesh_of(name)
            for fsdp in (False, True):
                specs = param_pspecs(cfg, shapes, MeshAxes(mesh), fsdp=fsdp)
                rep = {}
                for p, spec in jax.tree_util.tree_flatten_with_path(
                        specs, is_leaf=lambda x: isinstance(x, P))[0]:
                    k = key_of(p)
                    arr = npz[k]
                    if dtypes[k] == "bfloat16":
                        arr = arr.view(ml_dtypes.bfloat16)
                    rep[k] = shards(jax.device_put(
                        arr, NamedSharding(mesh, spec)), mesh)
                out["place"][f"{arch}|{name}|{fsdp}"] = rep

    # (i) composed axes on one dim
    x = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    for name in ("2x4", "1x8"):
        mesh = mesh_of(name)
        out["place"][f"composed|{name}"] = [
            shards(jax.device_put(x, NamedSharding(mesh, P(*[
                tuple(e) if isinstance(e, list) else e for e in spec]))), mesh)
            for spec in job["composed"]]

    # (ii) the port's checkpoint, restored with a whole shardings tree
    cfg = get_config("llama3.2-1b").reduced()
    model = get_model(cfg)
    params = model.init(jax.random.key(0))
    opt = get_optimizer(cfg)
    shapes = jax.eval_shape(lambda: params)
    mesh = mesh_of("2x4")
    pspecs = param_pspecs(cfg, shapes, MeshAxes(mesh))
    sh = to_named(mesh, {"params": pspecs,
                         "opt": opt.state_pspecs(pspecs, shapes)})
    state, step = ckpt.restore(job["ckpt"], {"params": params,
                                             "opt": opt.init(params)},
                               shardings=sh)
    out["restore"] = report(state, mesh)
    out["restore_step"] = step
    out["n_sharded"] = sum(
        len({tuple(map(tuple, s["index"])) for s in v}) > 1
        for v in out["restore"].values())

    # (iii) sharded batches
    for arch, name in job["batches"]:
        cfg = get_config(arch).reduced()
        shape = ShapeConfig("t", kind="train", **job["batch_shape"])
        spec = PipelineSpec(cfg, shape, seed=job["pipe_seed"])
        mesh = mesh_of(name)
        host = spec.batch(job["batch_step"])
        sh = to_named(mesh, batch_pspecs(cfg, shape, host, MeshAxes(mesh)))
        out["batch"][f"{arch}|{name}"] = report(
            spec.device_batch(job["batch_step"], shardings=sh), mesh)

    # (iv) compressed_psum inside shard_map over 8 devices
    mesh = mesh_of("8")
    x = np.random.default_rng(job["psum_seed"]).standard_normal(
        job["psum_shape"]).astype(np.float32)
    got = jax.jit(shard_map_compat(
        lambda x_loc: compressed_psum(x_loc[0], "data"), mesh=mesh,
        in_specs=P("data"), out_specs=P()))(x)
    out["psum"] = np.asarray(got).astype(np.float32).tobytes().hex()
    print("REF " + json.dumps(out))
""")


def _mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, ["cpu"] * 8)


def _dtype_name(dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty(0, dtype=dtype).numpy().dtype)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _report(sharded: Sharded) -> list:
    """The reference subprocess's shard report of a port leaf."""
    return [dict(index=[[s.start, s.stop] for s in shard.index],
                 dtype=_dtype_name(shard.data.dtype),
                 shape=list(shard.data.shape),
                 sha=hashlib.sha256(_bits(shard.data).tobytes()).hexdigest())
            for shard in sharded.shards]


def _key(path) -> str:
    return "__".join(map(str, path))


def _param_leaves(arch):
    """(cfg, {path: RefLeaf}) of ``arch`` reduced, its values drawn from
    ``PARAM_SEED`` and held in the arch's dtype."""
    cfg = get_config(arch).reduced()
    from_arrays, dtype = PARAM_ARCHS[arch]
    api = registry.get_model(cfg, attn_backend="dense-ref")
    shapes = api.ref_leaves(registry.abstract_params(cfg))
    rng = np.random.default_rng(PARAM_SEED)
    arrays = {path: rng.standard_normal(leaf.shape).astype(np.float32)
              for path, leaf in shapes.items()}
    model = from_arrays(cfg, nest(arrays), dtype=dtype)
    return cfg, api.ref_leaves(model)


def _trainer(ckpt_dir=None):
    return Trainer(get_config("llama3.2-1b").reduced(),
                   ShapeConfig("t", kind="train", **TRAIN_SHAPE),
                   TrainerConfig(total_steps=2, ckpt_every=2, ckpt_dir=ckpt_dir),
                   device="cpu")


def _state_shardings(trainer, params, mesh):
    leaves = trainer.model.ref_leaves(params)
    pspecs = param_pspecs(trainer.cfg, leaves, MeshAxes(mesh))
    return {"params": placements(mesh, pspecs),
            "opt": placements(mesh, trainer.optimizer.state_pspecs(pspecs,
                                                                   leaves))}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The port's inputs on disk (the parameters' bits, a checkpoint) and
    the reference's report on them."""
    tmp = tmp_path_factory.mktemp("placement")
    params = {}
    for arch in PARAM_ARCHS:
        _, leaves = _param_leaves(arch)
        blobs = {_key(p): _bits(leaf.stacked()) for p, leaf in leaves.items()}
        dtypes = {_key(p): _dtype_name(leaf.parts[0].dtype)
                  for p, leaf in leaves.items()}
        params[arch] = str(tmp / f"{arch}.npz")
        np.savez(params[arch], __dtypes__=json.dumps(dtypes), **blobs)
    ckpt_dir = str(tmp / "ckpt")
    _trainer(ckpt_dir).fit()
    job = dict(meshes=MESHES, params=params, ckpt=ckpt_dir,
               batches=BATCH_CASES, batch_shape=BATCH_SHAPE,
               batch_step=BATCH_STEP, pipe_seed=PIPE_SEED,
               psum_shape=PSUM_SHAPE, psum_seed=PSUM_SEED, composed=COMPOSED)
    with open(tmp / "job.json", "w") as f:
        json.dump(job, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REFERENCE, str(tmp / "job.json")],
                         env=env, capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    lines = [l for l in res.stdout.splitlines() if l.startswith("REF ")]
    assert lines, res.stderr[-3000:]
    return dict(ref=json.loads(lines[-1][4:]), ckpt=ckpt_dir)


@pytest.mark.parametrize("fsdp", (False, True), ids=("tp", "fsdp"))
@pytest.mark.parametrize("mesh_name", tuple(MESHES))
@pytest.mark.parametrize("arch", tuple(PARAM_ARCHS))
def test_place_matches_device_put(work, arch, mesh_name, fsdp):
    want = work["ref"]["place"][f"{arch}|{mesh_name}|{fsdp}"]
    cfg, leaves = _param_leaves(arch)
    mesh = _mesh(mesh_name)
    specs = placements(mesh, param_pspecs(cfg, leaves, MeshAxes(mesh),
                                          fsdp=fsdp))
    placed = place_tree(leaves, specs)
    assert {_key(p) for p in placed} == set(want)
    for path, sharded in placed.items():
        assert isinstance(sharded, Sharded)
        assert _report(sharded) == want[_key(path)], path
        for n, (shard, dev) in enumerate(zip(sharded.shards, mesh.flat())):
            assert shard.data.device == dev and shard.data.is_contiguous()
        assert torch.equal(gather(sharded, "cpu"), leaves[path].stacked())


@pytest.mark.parametrize("mesh_name", ("2x4", "1x8"))
def test_place_composes_axes_row_major(work, mesh_name):
    want = work["ref"]["place"][f"composed|{mesh_name}"]
    mesh = _mesh(mesh_name)
    x = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
    for spec, shards in zip(COMPOSED, want, strict=True):
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        sharded = place(x, Placement(mesh, spec))
        assert _report(sharded) == shards, spec
        assert torch.equal(gather(sharded, "cpu"), x)


def test_restore_with_shardings_matches_the_reference(work):
    ref = work["ref"]
    mesh = _mesh("2x4")
    trainer = _trainer()
    params, opt_state, _ = trainer.init_state()
    tree_like = trainer.state_tree(params, opt_state)
    before = {p: _bits(l.stacked() if isinstance(l, RefLeaf) else l).copy()
              for p, l in flatten(tree_like).items()}
    state, step = ckpt.restore(work["ckpt"], tree_like,
                               shardings=_state_shardings(trainer, params, mesh))
    assert step == ref["restore_step"] == 2
    flat = flatten(state)
    assert {_key(p) for p in flat} == set(ref["restore"])
    for path, sharded in flat.items():
        assert isinstance(sharded, Sharded), path
        assert _report(sharded) == ref["restore"][_key(path)], path
    # the likes gave structure and shapes only
    for path, like in flatten(tree_like).items():
        now = like.stacked() if isinstance(like, RefLeaf) else like
        assert np.array_equal(_bits(now), before[path]), path
    # gather == the unsharded restore, bit for bit
    fresh = _trainer()
    p2, o2, _ = fresh.init_state()
    whole, _ = ckpt.restore(work["ckpt"], fresh.state_tree(p2, o2))
    for path, like in flatten(whole).items():
        value = like.stacked() if isinstance(like, RefLeaf) else like
        got = gather(flat[path], "cpu")
        assert got.dtype == value.dtype and torch.equal(got, value.detach()), path
    split = sum(s.blocks > 1 for s in flat.values())
    assert split == ref["n_sharded"] > 0


def test_restore_writes_unplaced_leaves_in_place(work):
    mesh = _mesh("2x4")
    trainer = _trainer()
    params, opt_state, _ = trainer.init_state()
    tree_like = trainer.state_tree(params, opt_state)
    shardings = _state_shardings(trainer, params, mesh)
    shardings["opt"] = None                          # a whole subtree
    unplaced = ("blocks", "attn", "wq")
    shardings["params"][unplaced] = None             # one leaf
    state, _ = ckpt.restore(work["ckpt"], tree_like, shardings=shardings)
    arrays, _ = ckpt.load_arrays(work["ckpt"])
    saved = flatten(arrays)
    assert state["opt"]["m"] is not tree_like["opt"]["m"]  # a new tree
    for path, leaf in flatten(state).items():
        like = flatten(tree_like)[path]
        if path[0] == "opt" or path == ("params",) + unplaced:
            assert leaf is like, path
            value = like.stacked() if isinstance(like, RefLeaf) else like
            np.testing.assert_array_equal(value.detach().float().numpy(),
                                          saved[path])
        else:
            assert isinstance(leaf, Sharded), path
    assert int(state["opt"]["step"]) == 2
    # without shardings the likes come back themselves
    again, _ = ckpt.restore(work["ckpt"], tree_like)
    assert again is tree_like


@pytest.mark.parametrize("arch,mesh_name", BATCH_CASES)
def test_device_batch_shardings_match_the_reference(work, arch, mesh_name):
    want = work["ref"]["batch"][f"{arch}|{mesh_name}"]
    cfg = get_config(arch).reduced()
    shape = ShapeConfig("t", kind="train", **BATCH_SHAPE)
    spec = PipelineSpec(cfg, shape, seed=PIPE_SEED)
    mesh = _mesh(mesh_name)
    host = spec.batch(BATCH_STEP)
    shardings = placements(mesh, batch_pspecs(cfg, shape, host, MeshAxes(mesh)))
    got = spec.device_batch(BATCH_STEP, device="cpu", shardings=shardings)
    assert set(got) == set(want) == set(host)
    for k, sharded in got.items():
        assert _report(sharded) == want[k], k
        for shard in sharded.shards:
            np.testing.assert_array_equal(shard.data.numpy(), host[k][shard.index])
    # a key left out of shardings comes whole to the device
    part = spec.device_batch(BATCH_STEP, device="cpu",
                             shardings={"tokens": shardings["tokens"]})
    assert isinstance(part["tokens"], Sharded)
    np.testing.assert_array_equal(part["labels"].numpy(), host["labels"])


def test_compressed_psum_matches_the_reference(work):
    x = np.random.default_rng(PSUM_SEED).standard_normal(PSUM_SHAPE).astype(
        np.float32)
    got = compressed_psum([torch.from_numpy(x[i]) for i in range(len(x))])
    want = np.frombuffer(bytes.fromhex(work["ref"]["psum"]), np.float32
                         ).reshape(PSUM_SHAPE[1:])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    scale = float(np.max(np.abs(x))) / 127.0
    np.testing.assert_allclose(got.numpy(), x.sum(axis=0), atol=8 * scale)
    with pytest.raises(ValueError, match="shape"):
        compressed_psum([torch.zeros(2), torch.zeros(3)])


def test_place_raises_on_an_indivisible_dim():
    mesh = _mesh("2x4")
    with pytest.raises(ValueError, match="not divisible"):
        place(torch.zeros(6, 4), Placement(mesh, P("model")))
    with pytest.raises(ValueError, match="not divisible"):
        place(torch.zeros(4, 4), Placement(mesh, P(("data", "model"))))
    with pytest.raises(ValueError, match="longer than the rank"):
        place(torch.zeros(4), Placement(mesh, P(None, "model")))
    with pytest.raises(ValueError, match="lacks"):
        place(torch.zeros(4), Placement(mesh, P("seq")))


def test_place_reuses_a_replica_on_a_repeated_device():
    mesh = _mesh("2x4")
    x = torch.arange(32.0).reshape(4, 8)
    sharded = place(x, Placement(mesh, P(None, "model")))
    assert sharded.blocks == 4
    data = [s.data for s in sharded.shards]
    # entries (0, m) and (1, m) hold the same block on the same device
    for m in range(4):
        assert data[m] is data[4 + m]
        assert torch.equal(data[m], x[:, 2 * m: 2 * m + 2])
    assert data[0].data_ptr() != x.data_ptr()   # a copy, not a view of x
    assert place_tree({"a": x, "b": [x]}, {"a": None, "b": [None]})["a"] is x


def test_device_batch_raises_without_a_card_unless_asked_for_the_cpu(
        monkeypatch):
    spec = PipelineSpec(get_config("llama3.2-1b").reduced(),
                        ShapeConfig("t", kind="train", **BATCH_SHAPE))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spec.device_batch(0)
    got = spec.device_batch(0, device="cpu")
    assert got["tokens"].device.type == "cpu"
