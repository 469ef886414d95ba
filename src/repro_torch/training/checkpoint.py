"""Async, integrity-checked checkpoints in the reference's on-disk layout.

Layout (the reference's, byte for byte where the values are): ``<dir>/
step_<N>/`` with one ``.npy`` per leaf, named by the CRC32 of the leaf's
path (its keys joined with ``__``), and ``manifest.json`` holding each
leaf's file, shape, logical dtype and the CRC32 of its bytes, the step and
a free-form ``meta``.  bf16 leaves are stored as their ``uint16`` bits with
``"bfloat16"`` as the logical dtype.  A step is written to ``step_<N>.tmp``
and published by one rename.  The reference's ``restore`` reads the
port's checkpoints and this module reads the reference's.

A tree is a nested dict whose leaves are tensors, numpy arrays or
:class:`~repro_torch.models.param_tree.RefLeaf`\\ s (a stacked leaf of the
reference's tree over the port's per-layer tensors); ``None`` subtrees
have no leaves.  :func:`restore` writes a checkpoint into the tensors of a
tree like the one saved, in place; :func:`load_arrays` reads one as numpy
(what a family's ``params_from_arrays`` takes).  :class:`AsyncCheckpointer`
copies the tree to host memory before it returns (so the next optimizer
step, which writes the parameters in place, cannot race the write) and
writes the files on a worker thread.  ``restore(..., shardings=)`` is the
elastic restore: a checkpoint written on one mesh comes back placed on
another (``distributed/sharding.py``), each shard cut on the host and
copied to its own device.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import Placement, place
from repro_torch.models.param_tree import Path, RefLeaf, flatten, nest

__all__ = ["save", "restore", "load_arrays", "latest_steps",
           "AsyncCheckpointer"]

_SEP = "__"

# leaf path -> (the array np.save writes, its logical dtype)
Snapshot = Dict[str, Tuple[np.ndarray, str]]


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf's saveable host array and logical dtype; bf16 as its uint16
    bits (numpy has no bf16).  A tensor is copied to the host (a blocking
    copy) before this returns."""
    if isinstance(leaf, RefLeaf):
        parts = [_host(p)[0] for p in leaf.parts]
        arr = np.stack(parts).reshape(leaf.shape) if leaf.lead else parts[0]
        bf16 = leaf.parts[0].dtype == torch.bfloat16
        return arr, "bfloat16" if bf16 else str(arr.dtype)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy(), "bfloat16"
        return t.numpy().copy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _snapshot(tree: Any) -> Snapshot:
    return {_SEP.join(path): _host(leaf) for path, leaf in flatten(tree).items()}


def _write(ckpt_dir: str, step: int, snap: Snapshot,
           meta: Optional[dict] = None) -> str:
    out = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = out + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "meta": meta or {}, "leaves": {}}
    for name, (arr, logical) in snap.items():
        fname = f"{zlib.crc32(name.encode()):08x}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][name] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": logical,
            "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(out):
        shutil.rmtree(out)
    os.replace(tmp, out)  # atomic publish
    return out


def save(ckpt_dir: str, step: int, tree: Any, meta: Optional[dict] = None) -> str:
    """Synchronous save; returns the step directory."""
    return _write(ckpt_dir, step, _snapshot(tree), meta)


class AsyncCheckpointer:
    """Snapshot to host memory, then write on a worker thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = None

    def save_async(self, step: int, tree: Any, meta: Optional[dict] = None):
        snap = _snapshot(tree)  # the host copy is complete here
        self.wait()
        self._pending = self._pool.submit(self._write, step, snap, meta)

    def _write(self, step, snap, meta):
        path = _write(self.ckpt_dir, step, snap, meta)
        self._gc()
        return path

    def _gc(self):
        for s in latest_steps(self.ckpt_dir)[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self):
        self.wait()
        self._pool.shutdown()


def latest_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def _read(ckpt_dir: str, step: Optional[int], names, verify: bool):
    """``({name: (saved array, logical dtype)}, step)`` for ``names`` (every
    leaf when ``None``)."""
    steps = latest_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step = steps[-1] if step is None else step
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    names = list(manifest["leaves"]) if names is None else list(names)
    missing = set(names) - set(manifest["leaves"])
    if missing:
        raise ValueError(f"checkpoint missing leaves: {sorted(missing)[:5]} …")
    arrays = {}
    for name in names:
        entry = manifest["leaves"][name]
        arr = np.load(os.path.join(src, entry["file"]))
        if verify:
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if crc != entry["crc32"]:
                raise IOError(f"CRC mismatch for {name} in {src}")
        arrays[name] = (arr, entry["dtype"])
    return arrays, step


def _tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    # writable and in C order (what np.load returns is kept, not copied)
    arr = np.require(arr, requirements=("C", "W"))
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _placement_paths(tree: Any, prefix: Path = ()
                     ) -> Dict[Path, Optional[Placement]]:
    """``{path: Placement or None}`` of a ``shardings`` tree; a dict keyed
    by path tuples (``placements`` of ``param_pspecs``) spreads its keys
    into the path, and a ``None`` may stand for a whole subtree."""
    if tree is None or isinstance(tree, Placement):
        return {prefix: tree}
    if not isinstance(tree, Mapping):
        raise TypeError(f"shardings holds Placements, None and dicts, not "
                        f"{type(tree).__name__} at {prefix}")
    out: Dict[Path, Optional[Placement]] = {}
    for key, sub in tree.items():
        keys = tuple(map(str, key)) if isinstance(key, tuple) else (str(key),)
        out.update(_placement_paths(sub, prefix + keys))
    return out


def _placement_of(table: Dict[Path, Optional[Placement]], path: Path
                  ) -> Optional[Placement]:
    for n in range(len(path), -1, -1):
        if path[:n] in table:
            return table[path[:n]]
    raise ValueError(f"shardings has no entry for leaf {path}")


def _with_leaves(tree: Any, new: Dict[Path, Any], prefix: Path = ()) -> Any:
    """``tree`` rebuilt with the leaves at ``new``'s paths replaced."""
    if isinstance(tree, Mapping):
        return {k: _with_leaves(v, new, prefix + (str(k),))
                for k, v in tree.items()}
    return new.get(prefix, tree)


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None,
            shardings: Any = None, verify: bool = True) -> Tuple[Any, int]:
    """Load a checkpoint (the latest, or ``step``) into ``tree_like``, whose
    leaves are tensors and :class:`RefLeaf`\\ s: each is written in place
    (cast to its dtype).  Returns (``tree_like``, the step).

    ``shardings`` (the reference's elastic restore): a tree shaped like
    ``tree_like`` whose leaves are ``distributed.sharding.Placement``\\ s
    or ``None`` (for a training state, ``{"params": placements(mesh,
    param_pspecs(...)), "opt": placements(mesh, opt.state_pspecs(...))}``).
    A leaf with a placement comes back as a ``Sharded`` of the saved dtype,
    as the reference's ``device_put`` gives it: its shards are cut on the
    host from the loaded array and copied each to its own device, so the
    whole leaf never sits on one device, and its like is left as it was.
    The other leaves are written in place as above.  The return value is
    then a new tree, the placed leaves in place of their likes."""
    flat_like = flatten(tree_like)
    arrays, step = _read(ckpt_dir, step,
                         [_SEP.join(p) for p in flat_like], verify)
    table = None if shardings is None else _placement_paths(shardings)
    placed: Dict[Path, Any] = {}
    for path, like in flat_like.items():
        t = _tensor(*arrays[_SEP.join(path)])
        if tuple(like.shape) != tuple(t.shape):
            raise ValueError(f"leaf {path}: shape {tuple(t.shape)} != "
                             f"{tuple(like.shape)}")
        placement = None if table is None else _placement_of(table, path)
        if placement is not None:
            placed[path] = place(t, placement)
        elif isinstance(like, RefLeaf):
            like.assign(t)
        else:
            with torch.no_grad():
                like.copy_(t)
    if table is None:
        return tree_like, step
    return _with_leaves(tree_like, placed), step


def load_arrays(ckpt_dir: str, step: Optional[int] = None,
                verify: bool = True) -> Tuple[Dict[str, Any], int]:
    """Every leaf of a checkpoint as numpy, nested by its path (bf16 widened
    to fp32, which is exact): what a family's ``params_from_arrays`` takes
    under ``"params"``."""
    arrays, step = _read(ckpt_dir, step, None, verify)
    flat = {}
    for name, (arr, logical) in arrays.items():
        if logical == "bfloat16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        flat[tuple(name.split(_SEP))] = arr
    return nest(flat), step
