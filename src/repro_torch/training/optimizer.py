"""Optimizers and learning-rate schedules: the reference's math, in torch.

* AdamW — fp32 moments, decoupled weight decay on matrices only,
  global-norm clipping.
* Adafactor — factored second moments, no first moment.
* Schedules: linear-warmup cosine, and WSD (warmup-stable-decay) for
  minicpm [arXiv:2404.06395].

The optimizers work on the reference's parameter tree, read over the
port's modules (``models/param_tree.py``): a dict from each leaf's path to
its :class:`~repro_torch.models.param_tree.RefLeaf`, whose parts are the
port's per-layer tensors.  A stacked leaf is one leaf, as in the
reference: its rank decides weight decay (a stacked norm weight ``[L, d]``
is a matrix there, and is decayed), and Adafactor factors and clips its
update over the whole stacked leaf.  ``update`` writes the new parameters
and state into their tensors in place and returns them; every product and
bias correction runs in fp32 and the parameter is cast back to its dtype
once, as the reference's ``upd`` does.  The step's scalars (learning rate,
bias corrections) are computed in fp32 on the host and moved to the
parameters' device as 0-d tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Tuple

import torch

from repro_torch.distributed.sharding import P
from repro_torch.models.param_tree import Path, RefLeaf

__all__ = ["cosine_schedule", "wsd_schedule", "get_schedule", "global_norm",
           "clip_by_global_norm", "AdamW", "Adafactor", "get_optimizer"]

F32 = torch.float32
Tree = Dict[Path, RefLeaf]


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable[[Any], torch.Tensor]:
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(1.0, warmup)
        t = torch.clamp((step - warmup) / max(1.0, total - warmup), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def wsd_schedule(base_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1,
                 min_frac: float = 0.01) -> Callable[[Any], torch.Tensor]:
    """Warmup-Stable-Decay (minicpm): flat plateau, short final decay."""
    decay_start = int(total * (1.0 - decay_frac))
    log_min = torch.log(_f32(max(min_frac, 1e-8)))

    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(1.0, warmup)
        t = torch.clamp((step - decay_start) / max(1.0, total - decay_start),
                        0.0, 1.0)
        decay = base_lr * torch.exp(log_min * t)
        out = torch.where(step < warmup, warm, _f32(base_lr))
        return torch.where(step >= decay_start, decay, out)
    return lr


def get_schedule(name: str, base_lr: float, warmup: int, total: int):
    if name == "wsd":
        return wsd_schedule(base_lr, warmup, total)
    return cosine_schedule(base_lr, warmup, total)


# ---------------------------------------------------------------------------
# common utilities
# ---------------------------------------------------------------------------


def global_norm(tree: Mapping[Path, RefLeaf]) -> torch.Tensor:
    """The fp32 2-norm over every part of every leaf."""
    sums = [torch.sum(torch.square(p.to(F32)))
            for leaf in tree.values() for p in leaf.parts]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(tree: Mapping[Path, RefLeaf], max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale by ``min(1, max_norm / norm)`` in fp32, each part cast back to
    its dtype; returns (the scaled tree, the norm)."""
    norm = global_norm(tree)
    # a true division (``float / tensor`` would multiply by a reciprocal)
    scale = torch.clamp(torch.div(_f32(max_norm).to(norm.device),
                                  torch.clamp(norm, min=1e-9)), max=1.0)
    return ({k: leaf.map(lambda g: (g.to(F32) * scale).to(g.dtype))
             for k, leaf in tree.items()}, norm)


def _zeros_like(tree: Mapping[Path, RefLeaf]) -> Tree:
    return {k: leaf.map(lambda p: torch.zeros(p.shape, dtype=F32,
                                              device=p.device))
            for k, leaf in tree.items()}


def _device_of(tree: Mapping[Path, RefLeaf]) -> torch.device:
    return next(iter(tree.values())).parts[0].device


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: Mapping[Path, RefLeaf]) -> Dict[str, Any]:
        """``{"m", "v"}``: fp32 zeros shaped like the parameters; ``"step"``:
        a 0-d int32 tensor on the host."""
        return {"m": _zeros_like(params), "v": _zeros_like(params),
                "step": torch.zeros((), dtype=torch.int32)}

    def update(self, grads: Mapping[Path, RefLeaf], state: Dict[str, Any],
               params: Mapping[Path, RefLeaf]):
        """One step in place; returns (params, state, metrics)."""
        grads, gnorm = clip_by_global_norm(grads, self.clip_norm)
        step = state["step"] + 1
        lr = self.schedule(step)
        stepf = step.to(F32)
        dev = _device_of(params)
        bc1 = (1 - _f32(self.b1) ** stepf).to(dev)
        bc2 = (1 - _f32(self.b2) ** stepf).to(dev)
        lr_d = lr.to(dev)
        b1, b2 = self.b1, self.b2
        with torch.no_grad():
            for key, leaf in params.items():
                decay = leaf.ndim >= 2  # decoupled decay on matrices only
                for p, g, m, v in zip(leaf.parts, grads[key].parts,
                                      state["m"][key].parts,
                                      state["v"][key].parts):
                    g = g.to(F32)
                    m2 = b1 * m + (1 - b1) * g
                    v2 = b2 * v + (1 - b2) * g * g
                    mhat = m2 / bc1
                    vhat = v2 / bc2
                    delta = mhat / (torch.sqrt(vhat) + self.eps)
                    if decay:
                        delta = delta + self.weight_decay * p.to(F32)
                    p.copy_((p.to(F32) - lr_d * delta).to(p.dtype))
                    m.copy_(m2)
                    v.copy_(v2)
        state["step"] = step
        return params, state, {"grad_norm": gnorm, "lr": lr}

    def state_pspecs(self, param_specs: Mapping[Path, Any],
                     params: Mapping[Path, RefLeaf]) -> Dict[str, Any]:
        """The state's partition specs (``distributed/sharding.py``): each
        moment placed as its parameter; the step replicated."""
        return {"m": dict(param_specs), "v": dict(param_specs), "step": P()}


# ---------------------------------------------------------------------------
# Adafactor (factored second moments, no momentum)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Adafactor:
    schedule: Callable
    decay: float = 0.99
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def init(self, params: Mapping[Path, RefLeaf]) -> Dict[str, Any]:
        """``{"vr", "vc"}``: each leaf's factored moments over the whole
        (stacked) leaf, as one fp32 tensor; ``"step"``: as AdamW's."""
        def vr(leaf):
            shape = leaf.shape[:-1] if leaf.ndim >= 2 else leaf.shape
            return torch.zeros(shape, dtype=F32, device=leaf.parts[0].device)

        def vc(leaf):
            shape = (leaf.shape[:-2] + leaf.shape[-1:] if leaf.ndim >= 2
                     else (0,))
            return torch.zeros(shape, dtype=F32, device=leaf.parts[0].device)

        return {"vr": {k: vr(leaf) for k, leaf in params.items()},
                "vc": {k: vc(leaf) for k, leaf in params.items()},
                "step": torch.zeros((), dtype=torch.int32)}

    def update(self, grads: Mapping[Path, RefLeaf], state: Dict[str, Any],
               params: Mapping[Path, RefLeaf]):
        """One step in place; returns (params, state, metrics)."""
        step = state["step"] + 1
        lr = self.schedule(step)
        lr_d = lr.to(_device_of(params))
        d, eps = self.decay, self.eps
        with torch.no_grad():
            for key, leaf in params.items():
                g = grads[key].stacked().to(F32)
                vr, vc = state["vr"][key], state["vc"][key]
                g2 = g * g + eps
                if g.dim() >= 2:
                    vr2 = d * vr + (1 - d) * g2.mean(dim=-1)
                    vc2 = d * vc + (1 - d) * g2.mean(dim=-2)
                    # factored precondition: g / sqrt(outer(vr, vc) / mean(vr))
                    u = g * torch.rsqrt(
                        vr2[..., :, None] * vc2[..., None, :]
                        / torch.clamp(vr2.mean(dim=-1)[..., None, None],
                                      min=eps)
                        + eps)
                else:
                    vr2 = d * vr + (1 - d) * g2
                    vc2 = vc
                    u = g * torch.rsqrt(vr2 + eps)
                # update clipping (RMS <= threshold)
                rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
                u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
                p = leaf.stacked()
                if self.weight_decay and p.dim() >= 2:
                    u = u + self.weight_decay * p.to(F32)
                leaf.assign((p.to(F32) - lr_d * u).to(p.dtype))
                vr.copy_(vr2)
                vc.copy_(vc2)
        state["step"] = step
        return params, state, {"lr": lr}

    def state_pspecs(self, param_specs: Mapping[Path, Any],
                     params: Mapping[Path, RefLeaf]) -> Dict[str, Any]:
        """The state's partition specs: ``vr`` drops the parameter spec's
        last dim and ``vc`` its second to last (a vector's ``vr`` is placed
        as the vector, its empty ``vc`` replicated); the step replicated."""
        def pad(spec, ndim):
            t = tuple(spec)
            return (None,) * (ndim - len(t)) + t

        def vr_spec(spec, leaf):
            nd = len(leaf.shape)
            return P(*pad(spec, nd)[:-1]) if nd >= 2 else P(*pad(spec, nd))

        def vc_spec(spec, leaf):
            nd = len(leaf.shape)
            if nd >= 2:
                s = pad(spec, nd)
                return P(*(s[:-2] + (s[-1],)))
            return P()

        return {"vr": {k: vr_spec(s, params[k]) for k, s in param_specs.items()},
                "vc": {k: vc_spec(s, params[k]) for k, s in param_specs.items()},
                "step": P()}


def get_optimizer(cfg, total_steps: int = 10_000, base_lr: float = 3e-4,
                  warmup: int = 200):
    sched = get_schedule(cfg.lr_schedule, base_lr, warmup, total_steps)
    if cfg.optimizer == "adafactor":
        return Adafactor(schedule=sched)
    return AdamW(schedule=sched)
