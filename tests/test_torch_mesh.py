"""The port's mesh helpers (``launch/mesh.py``: ``make_mesh``, ``Mesh``,
``MeshAxes``, ``mesh_axes_of``) and its sharding context
(``models/layers.py``: ``set_shard_ctx``, ``shard_ctx``,
``set_tp_psum_dtype``, ``constrain``) against the JAX package's, on the
CPU.

The reference's ``MeshAxes`` reads only a mesh's ``axis_names`` and
``shape``; this image's CPU jax has one device, so it is held on meshes of
many shapes through a stand-in with those two fields, and on a real
``(1, 1)`` JAX mesh as well.
"""

import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    Mesh,
    MeshAxes,
    make_mesh,
    make_worker_mesh,
    mesh_axes_of,
)
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

SHAPES = [((4,), ("seq",)), ((1, 4), ("data", "model")),
          ((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((3,), ("worker",)), ((2, 3), ("model", "seq"))]


def _axes(a):
    return (a.model, a.dp, a.dp_size, a.model_size,
            a.axis_size(None), a.axis_size(a.dp) if a.dp else 1)


@pytest.mark.parametrize("shape,axes", SHAPES,
                         ids=["x".join(map(str, s)) for s, _ in SHAPES])
def test_mesh_axes_match_the_reference(shape, axes):
    mesh = make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))
    stand_in = types.SimpleNamespace(axis_names=axes,
                                     shape=dict(zip(axes, shape)))
    want = ref_mesh.MeshAxes(stand_in)
    got = mesh_axes_of(mesh)
    assert isinstance(got, MeshAxes)
    assert _axes(got) == _axes(want)
    assert _axes(got.as_pure_dp()) == _axes(want.as_pure_dp())
    for name in axes:
        assert got.axis_size(name) == want.axis_size(name)
    assert got.axis_size(tuple(axes)) == want.axis_size(tuple(axes))
    assert mesh.shape == dict(zip(axes, shape))
    assert mesh.size == int(np.prod(shape))


def test_mesh_axes_on_a_real_jax_mesh():
    want = ref_mesh.MeshAxes(ref_mesh.make_mesh((1, 1), ("data", "model")))
    got = MeshAxes(make_mesh((1, 1), ("data", "model"), ["cpu"]))
    assert _axes(got) == _axes(want)


def test_mesh_entries_order_and_sub_meshes():
    devs = [torch.device("cpu")] * 6
    mesh = make_mesh((2, 3), ("data", "model"), devs)
    assert isinstance(mesh, Mesh) and mesh.devices.shape == (2, 3)
    assert mesh.along("model") == devs[:3] and mesh.along("data") == devs[:2]
    assert mesh.flat() == devs
    sub = mesh.axis_mesh("model")
    assert sub.axis_names == ("model",) and sub.shape == {"model": 3}
    # a mesh may repeat a device; strings name devices
    assert make_mesh((4,), ("seq",), ["cpu"] * 4).flat() == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="takes 6 devices"):
        make_mesh((2, 3), ("data", "model"), devs[:5])
    with pytest.raises(ValueError, match="as many"):
        make_mesh((2, 3), ("data",), devs)
    with pytest.raises(ValueError, match="repeat"):
        make_mesh((2, 3), ("data", "data"), devs)
    # the dry run's meshes are of the meta device; no other kind is taken
    assert make_mesh((2,), ("seq",), ["meta"] * 2).flat() == [torch.device("meta")] * 2
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        make_mesh((1,), ("seq",), ["mps"])


def test_meshes_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is available"):
        make_mesh((2,), ("seq",))
    with pytest.raises(RuntimeError, match="none is available"):
        make_worker_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh((2,), ("seq",)).flat() == [torch.device("cuda", 0),
                                                torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="2 visible"):
        make_mesh((4,), ("seq",))
    assert make_worker_mesh(1) == [torch.device("cuda", 0)]
    # a bare "cuda" names the current device by its index, as a tensor's
    # device does, so a shard on it compares equal to its mesh entry
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert make_mesh((2,), ("seq",), ["cuda"] * 2).flat() == \
        [torch.device("cuda", 1)] * 2
    assert attention.shard_devices([torch.device("cuda")]) == \
        [torch.device("cuda", 1)]


def test_shard_ctx_matches_the_reference():
    mesh = make_mesh((1, 4), ("data", "model"), ["cpu"] * 4)
    try:
        for mod, m in ((L, mesh), (ref_layers, None)):
            assert mod.shard_ctx() == {"mesh": None, "dp": (), "model": None}
            mod.set_shard_ctx(m, ["data"], "model")
            ctx = mod.shard_ctx()
            assert ctx == {"mesh": m, "dp": ("data",), "model": "model"}
            ctx["model"] = "other"          # a copy: the context is unchanged
            assert mod.shard_ctx()["model"] == "model"
            mod.set_shard_ctx()
        x = torch.arange(12.0).reshape(3, 4)
        L.set_shard_ctx(mesh, ("data",), "model")
        assert L.constrain(x, "dp", "model") is x
        assert L.constrain(x, None, None) is x
    finally:
        L.set_shard_ctx()
        ref_layers.set_shard_ctx()
    assert L.TP_PSUM_DTYPE == torch.float32
    assert ref_layers.TP_PSUM_DTYPE == jnp.float32
    try:
        L.set_tp_psum_dtype(torch.bfloat16)
        assert L.TP_PSUM_DTYPE == torch.bfloat16
    finally:
        L.set_tp_psum_dtype(torch.float32)
