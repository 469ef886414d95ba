"""The reference's parameter tree, read over the port's modules.

The reference keeps a model's parameters in a nested dict whose block
leaves are stacked on a leading layer axis (``blocks/attn/wq [L, d, H,
Dh]``; the hybrid family's ``groups`` on two, ``[n_full, g, ...]``).  The
port keeps one tensor a layer in ``ModuleList``\\ s.  A :class:`RefLeaf`
names one leaf of the reference's tree by its path and holds the port's
tensors that make it up, in the stacking order; :func:`ref_leaves` reads
them off a module.  The optimizers work leaf by leaf, as the reference's
do on its tree (a stacked leaf's rank decides weight decay and Adafactor's
factoring), and checkpoints are written under the reference's leaf names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

Path = Tuple[str, ...]

__all__ = ["Path", "RefLeaf", "ref_leaves", "nest", "flatten", "to_numpy",
           "leaves_to_arrays"]


@dataclasses.dataclass
class RefLeaf:
    """One leaf of the reference's tree: ``parts`` are the port's tensors
    that the reference stacks on the axes ``lead`` (row-major; ``()`` for
    an unstacked leaf, whose one part is the leaf)."""

    lead: Tuple[int, ...]
    parts: List[torch.Tensor]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.lead) + tuple(self.parts[0].shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def stacked(self) -> torch.Tensor:
        """The leaf as the reference holds it (a copy when stacked)."""
        if not self.lead:
            return self.parts[0]
        return torch.stack(list(self.parts)).reshape(self.shape)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "RefLeaf":
        return RefLeaf(self.lead, [fn(p) for p in self.parts])

    def assign(self, full) -> None:
        """Write a whole leaf (a tensor or an array of :attr:`shape`) into
        the parts, in place."""
        full = torch.as_tensor(full)
        if tuple(full.shape) != self.shape:
            raise ValueError(f"leaf shape {tuple(full.shape)} != {self.shape}")
        rows = full.reshape((-1,) + tuple(self.parts[0].shape))
        with torch.no_grad():
            for part, row in zip(self.parts, rows):
                part.copy_(row)


def ref_leaves(model: nn.Module,
               regroup: Optional[Callable[[Path, int, int], Tuple[Path, Tuple[int, ...]]]] = None,
               ) -> Dict[Path, RefLeaf]:
    """The reference's leaves over ``model``'s parameters, sorted by path
    (the order the reference's tree flattens in).

    A parameter ``name.i.rest`` of a ``ModuleList`` ``name`` is row ``i`` of
    the leaf ``(name, *rest)``, stacked on ``(len(name),)``; any other is
    the leaf of its own dotted path.  ``regroup(path, i, n)`` may move a
    stacked leaf's row ``i`` of ``n`` elsewhere, returning the leaf's path
    and stacking axes (the hybrid family's groups and tail)."""
    out: Dict[Path, RefLeaf] = {}
    for name, p in model.named_parameters():
        parts = tuple(name.split("."))
        lead: Tuple[int, ...] = ()
        if len(parts) > 1 and parts[1].isdigit():
            n = len(getattr(model, parts[0]))
            path, i = (parts[0],) + parts[2:], int(parts[1])
            lead = (n,)
            if regroup is not None:
                path, lead = regroup(path, i, n)
            parts = path
        leaf = out.setdefault(parts, RefLeaf(lead, []))
        if leaf.lead != lead:
            raise ValueError(f"leaf {parts} stacked on {leaf.lead} and {lead}")
        leaf.parts.append(p)
    return dict(sorted(out.items()))


def nest(flat: Mapping[Path, Any]) -> Dict[str, Any]:
    """``{("a", "b"): x}`` → ``{"a": {"b": x}}``."""
    out: Dict[str, Any] = {}
    for path, value in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def flatten(tree: Any, prefix: Path = ()) -> Dict[Path, Any]:
    """The leaves of a nested dict by path, in sorted order (the
    reference's flatten order); ``None`` subtrees have no leaves, as in a
    JAX pytree."""
    if tree is None:
        return {}
    if isinstance(tree, Mapping):
        out: Dict[Path, Any] = {}
        for key in sorted(tree):
            out.update(flatten(tree[key], prefix + (str(key),)))
        return out
    return {prefix: tree}


def to_numpy(t) -> np.ndarray:
    """A tensor (or leaf) on the host as numpy; bf16 widens to fp32, which
    is exact (numpy has no bf16 of its own)."""
    if isinstance(t, RefLeaf):
        return np.stack([to_numpy(p) for p in t.parts]).reshape(t.shape) \
            if t.lead else to_numpy(t.parts[0])
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def leaves_to_arrays(leaves: Mapping[Path, RefLeaf],
                     empty: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """The reference's tree as numpy arrays (bf16 widened to fp32): the
    inverse of a family's ``params_from_arrays``.  ``empty`` names the
    subtrees the reference keeps as ``None`` when they hold no layer."""
    tree = nest({path: to_numpy(leaf) for path, leaf in leaves.items()})
    for key in empty:
        tree.setdefault(key, None)
    return tree
