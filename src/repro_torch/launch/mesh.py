"""Device meshes of the port.

The port has no SPMD runtime.  A mesh is a plain array of
``torch.device``\\ s with axis names (:class:`Mesh`); a sharded op takes its
shards as a list, one per mesh entry along its axis, with shard ``d`` on
that entry's device, and a collective becomes a reduction over the list on
the first shard's device, in shard order (``psum`` a sum, ``pmax`` a max).
A mesh may name one device more than once: ``make_mesh((4,), ("seq",),
[cuda:0] * 4)`` runs four shards on one card, and a mesh of the CPU runs
the kernels' plain versions.

* :func:`make_mesh` and :class:`Mesh`: the serving mesh (the sequence
  axis of ``generate_stream(mesh=...)``, the model axis of the moe
  family's expert parallelism); :class:`MeshAxes` and
  :func:`mesh_axes_of` resolve which axes carry data and which the model,
  as the reference's do.
* :func:`make_worker_mesh`: the sharded fleet backend's worker axis, a
  list of devices: shard ``d`` of a ``p_pad``-worker panel (rows ``d *
  p_pad / D`` up to the next shard) lives and runs on ``mesh[d]``.
* :func:`make_production_mesh`: the reference's production layout, a
  ``(16, 16)`` ``("data", "model")`` mesh or a ``(2, 16, 16)`` ``("pod",
  "data", "model")`` one, over the ``meta`` device: the dry run
  (``launch/dryrun.py``) places and costs a step on it and allocates
  nothing.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "make_worker_mesh",
           "MeshAxes", "mesh_axes_of", "resolve_device"]

# the device kinds a mesh may name: the card, the CPU, and ``meta`` (shapes
# without storage, for the dry run)
MESH_DEVICE_TYPES = ("cuda", "cpu", "meta")


def resolve_device(device) -> torch.device:
    """``device`` as tensors report theirs: ``"cuda"`` names the current
    CUDA device by its index (``cuda:0``), so a mesh entry compares equal
    to the device of a tensor placed on it."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        index = torch.cuda.current_device() if torch.cuda.is_available() else 0
        d = torch.device("cuda", index)
    return d


def _cuda_devices(n: Optional[int], what: str) -> List[torch.device]:
    """The first ``n`` visible CUDA devices (every one for ``None``); raises
    where none is visible, or fewer than ``n``."""
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible == 0:
        raise RuntimeError(
            f"{what} runs over CUDA devices by default and none is "
            f"available; pass the CPU's devices for a mesh of the CPU")
    n = visible if n is None else int(n)
    if not 1 <= n <= visible:
        raise ValueError(f"{n} CUDA devices asked for, {visible} visible; "
                         f"repeat a device in a list for more shards")
    return [torch.device("cuda", i) for i in range(n)]


class Mesh:
    """``devices``, an object array of ``torch.device`` of shape ``shape``,
    with one name an axis (``axis_names``); ``shape`` maps a name to its
    size, as a JAX mesh's does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a mesh of {devices.ndim} axes needs as many "
                             f"names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def along(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, every other axis at index 0: the
        shard list of an op over that axis (the other axes replicate)."""
        i = self.axis_names.index(axis)
        index = tuple(slice(None) if j == i else 0
                      for j in range(len(self.axis_names)))
        return list(self.devices[index])

    def flat(self) -> List[torch.device]:
        """Every entry, row-major: the shard order when an op shards over
        all of the mesh's axes (the reference composes several axis names
        row-major)."""
        return list(self.devices.reshape(-1))

    def axis_mesh(self, axis: str) -> "Mesh":
        """The 1-D mesh along ``axis`` (:meth:`along`)."""
        return Mesh(np.array(self.along(axis), dtype=object).reshape(-1),
                    (axis,))

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.flat()]})")


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes`` over ``devices`` (any
    sequence of ``prod(shape)`` devices, in row-major order; a device may
    repeat).  Where ``devices`` is omitted, the first ``prod(shape)``
    visible CUDA devices; it raises where there are too few."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if devices is None:
        devs = _cuda_devices(n, "make_mesh")
    else:
        devs = [resolve_device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"a mesh of shape {shape} takes {n} devices, "
                             f"got {len(devs)}")
        for d in devs:
            if d.type not in MESH_DEVICE_TYPES:
                raise ValueError(f"a mesh is over cuda, cpu or meta, not {d}")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    return Mesh(arr.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh over ``meta``: ``(16, 16)``
    ``("data", "model")``, or ``(2, 16, 16)`` ``("pod", "data", "model")``
    with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, [torch.device("meta")] * math.prod(shape))


def make_worker_mesh(n_devices: Optional[int] = None,
                     device: str = "cuda") -> List[torch.device]:
    """The worker mesh over ``device``'s kind.

    ``device="cuda"`` (the default): the first ``n_devices`` visible CUDA
    devices, every one of them when ``n_devices`` is ``None``; it raises
    where none is visible, or fewer than ``n_devices``.  ``device="cpu"``:
    ``n_devices`` (default 1) entries of the CPU, as the tests use it.
    """
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    if kind != "cuda":
        raise ValueError(f"a worker mesh is over cuda or cpu, not {device!r}")
    return _cuda_devices(n_devices, "make_worker_mesh")


class MeshAxes:
    """Resolved axis names for a mesh: which axes carry data vs model.

    ``as_pure_dp()`` reinterprets the whole mesh as data-parallel (the ZeRO
    strategy): every axis carries batch, no TP axis.
    """

    def __init__(self, mesh: Mesh):
        names = mesh.axis_names
        self.model: Optional[str] = "model" if "model" in names else None
        dp = tuple(n for n in names if n in ("pod", "data"))
        self.dp: Tuple[str, ...] = dp
        self.mesh = mesh

    def as_pure_dp(self) -> "MeshAxes":
        out = MeshAxes(self.mesh)
        out.dp = tuple(self.mesh.axis_names)
        out.model = None
        return out

    def axis_size(self, name) -> int:
        if name is None:
            return 1
        if isinstance(name, tuple):
            return int(np.prod([self.axis_size(n) for n in name]))
        return self.mesh.shape[name]

    @property
    def dp_size(self) -> int:
        return self.axis_size(self.dp) if self.dp else 1

    @property
    def model_size(self) -> int:
        return self.axis_size(self.model)


def mesh_axes_of(mesh: Mesh) -> MeshAxes:
    return MeshAxes(mesh)
