"""Weights drawn from the seed, on the device, in the type they are served in.

Each kind of leaf (``blocks.attn.wq`` over every layer, ...) is one tensor
``[layers, *shape]`` drawn in one call from a ``torch.Generator`` of its
own, seeded from the run's seed and the kind's place in the schema:
normal with variance 1/fan-in (the embedding tables 0.02^2), in the
configuration's dtype, the norms ones.  Those are the scales of the port's
own initializers.  The program gets the layers as its parameters; the
reference draws the same kinds again from the same seed after the
program's state is gone, so it reads nothing the program made.

Leaf names are the program's parameter names (``blocks.3.attn.wq``);
:func:`fill` checks that the program's module has exactly these leaves,
in these shapes and types.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from pbcore import spec

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class Kind:
    prefix: str          # "blocks", or "" for a single leaf
    suffix: str          # "attn.wq", ...
    layers: int          # 0 for a single leaf
    shape: Tuple[int, ...]
    dtype: str
    init: str            # "normal" (1/fan_in), "embed" (0.02) or "ones"
    fan_in: int = 1

    def names(self) -> List[str]:
        if not self.layers:
            return [self.suffix]
        return [f"{self.prefix}.{i}.{self.suffix}" for i in range(self.layers)]

    def numel(self) -> int:
        return max(1, self.layers) * math.prod(self.shape)


def schema(m: Dict[str, Any]) -> List[Kind]:
    """Every kind of leaf of the configuration's model, in a fixed order
    (the order seeds them): the embedding, the blocks of the model's
    family (``families/<family>.py``), the final norm and, untied, the
    unembedding."""
    V, d, dt = m["padded_vocab"], m["d_model"], m["param_dtype"]
    kinds = [Kind("", "embed", 0, (V, d), dt, "embed")]
    kinds += spec.family(m["family"]).block_kinds(m)
    kinds += [Kind("", "ln_f", 0, (d,), dt, "ones")]
    if not m.get("tie_embeddings", False):
        kinds += [Kind("", "unembed", 0, (V, d), dt, "embed")]
    return kinds


def param_count(m: Dict[str, Any]) -> int:
    return sum(k.numel() for k in schema(m))


def _kind_seed(seed: int, index: int) -> int:
    s = int(seed) % (1 << 64)
    ss = np.random.SeedSequence([s & 0xFFFFFFFF, s >> 32, 0x57EE, index])
    return int(ss.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def draw(kind: Kind, index: int, seed: int, device) -> torch.Tensor:
    """The kind's tensor ``[layers, *shape]`` (``shape`` for a single
    leaf), in its dtype on ``device``: one call to the generator."""
    shape = ((kind.layers,) if kind.layers else ()) + tuple(kind.shape)
    dt = _DTYPES[kind.dtype]
    if kind.init == "ones":
        return torch.ones(shape, dtype=dt, device=device)
    g = torch.Generator(device=device).manual_seed(_kind_seed(seed, index))
    t = torch.randn(shape, generator=g, device=device, dtype=dt)
    scale = 0.02 if kind.init == "embed" else 1.0 / math.sqrt(max(1, kind.fan_in))
    return t.mul_(scale)


def draw_all(m: Dict[str, Any], seed: int, device) -> Iterator[Tuple[Kind, torch.Tensor]]:
    """Each kind with its tensor, one at a time, in schema order."""
    for i, kind in enumerate(schema(m)):
        yield kind, draw(kind, i, seed, device)


def fill(module: torch.nn.Module, m: Dict[str, Any], seed: int) -> int:
    """Copy the seed's weights into ``module`` (the program's parameters,
    on their device), one kind at a time; raises unless the module has
    exactly the schema's leaves, shapes and types.  Returns the count of
    parameters written."""
    params = dict(module.named_parameters())
    want = {n for k in schema(m) for n in k.names()}
    if set(params) != want:
        raise ValueError(f"the program's leaves differ from the schema: "
                         f"missing {sorted(want - set(params))[:4]}, "
                         f"extra {sorted(set(params) - want)[:4]}")
    device = next(iter(params.values())).device
    count = 0
    with torch.no_grad():
        for kind, t in draw_all(m, seed, device):
            parts = t.unbind(0) if kind.layers else (t,)
            for name, part in zip(kind.names(), parts):
                p = params[name]
                if tuple(p.shape) != tuple(part.shape) or p.dtype != part.dtype:
                    raise ValueError(f"{name}: the program holds {tuple(p.shape)} "
                                     f"{p.dtype}, the schema {tuple(part.shape)} "
                                     f"{part.dtype}")
                p.copy_(part)
                count += part.numel()
            del t, parts
    return count


class Weights:
    """The reference's view of the seed's weights: every kind drawn again,
    held in its drawn type, handed out a layer at a time in fp32."""

    def __init__(self, m: Dict[str, Any], seed: int, device):
        self.kinds: Dict[str, torch.Tensor] = {}
        for kind, t in draw_all(m, seed, device):
            key = f"{kind.prefix}.{kind.suffix}" if kind.layers else kind.suffix
            self.kinds[key] = t

    def get(self, name: str, layer: Optional[int] = None) -> torch.Tensor:
        t = self.kinds[name]
        return (t if layer is None else t[layer]).float()

    def raw(self, name: str, layer: Optional[int] = None) -> torch.Tensor:
        t = self.kinds[name]
        return t if layer is None else t[layer]
