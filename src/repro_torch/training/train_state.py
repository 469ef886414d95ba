"""Train-step factory with microbatched gradient accumulation."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.param_tree import Path, RefLeaf

__all__ = ["make_train_step", "value_and_grad"]


def _flat(tree: Mapping[Path, RefLeaf]) -> List[torch.Tensor]:
    return [p for leaf in tree.values() for p in leaf.parts]


def _unflat(tree: Mapping[Path, RefLeaf], flat) -> Dict[Path, RefLeaf]:
    it = iter(flat)
    return {k: RefLeaf(leaf.lead, [next(it) for _ in leaf.parts])
            for k, leaf in tree.items()}


def value_and_grad(loss_fn: Callable, params: nn.Module, batch,
                   tree: Mapping[Path, RefLeaf]
                   ) -> Tuple[torch.Tensor, Dict[Path, RefLeaf]]:
    """``(loss, grads)`` of ``loss_fn(params, batch)``: the gradients of
    ``tree``'s parts (each in its parameter's dtype), in ``tree``'s
    structure; the loss detached."""
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, _flat(tree))
    return loss.detach(), _unflat(tree, grads)


def make_train_step(
    loss_fn: Callable[[nn.Module, Any], torch.Tensor],
    optimizer,
    ref_leaves: Callable[[nn.Module], Dict[Path, RefLeaf]],
    microbatches: int = 1,
    grad_shardings: Optional[Mapping[Path, Any]] = None,
) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)``, which updates ``params`` (a model whose parameters require
    gradients) and ``opt_state`` in place and returns them.
    ``ref_leaves(params)`` names the parameters by the reference's tree,
    which the optimizer works on.

    ``microbatches > 1`` splits the global batch along dim 0 and
    accumulates the gradients in fp32 microbatch by microbatch (the
    reference's ``lax.scan``), so activation memory scales with the
    microbatch; the loss and gradients are the microbatches' means.

    ``grad_shardings`` (``{path: Placement}``, ``distributed/sharding.py``)
    pins each gradient leaf, and each fp32 accumulator, to its parameter's
    placement through ``layers.constrain``, which places a value and never
    changes it: a step with it gives the same bits as a step without.
    """

    def pin(tree: Mapping[Path, RefLeaf]) -> Dict[Path, RefLeaf]:
        if grad_shardings is None:
            return dict(tree)
        return {k: leaf.map(lambda g, s=grad_shardings[k]: L.constrain(g, s))
                for k, leaf in tree.items()}

    def train_step(params: nn.Module, opt_state, batch: Mapping[str, torch.Tensor]):
        tree = ref_leaves(params)
        if microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch, tree)
            grads = pin(grads)
        else:
            def part(x, i):
                n = x.shape[0] // microbatches
                return x[i * n:(i + 1) * n]

            first = _flat(tree)[0]
            loss = torch.zeros((), dtype=torch.float32, device=first.device)
            acc = _flat(pin(_unflat(tree, [
                torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in _flat(tree)])))
            for i in range(microbatches):
                mb = {k: part(v, i) for k, v in batch.items()}
                l_i, g_i = value_and_grad(loss_fn, params, mb, tree)
                loss = loss + l_i
                acc = _flat(pin(_unflat(tree, [
                    a + g.to(torch.float32) for a, g in zip(acc, _flat(g_i))])))
            # true divisions (a host scalar would become a reciprocal's
            # product on the card)
            n = torch.tensor(float(microbatches), device=first.device)
            loss = loss / n
            grads = _unflat(tree, [a / n for a in acc])
        new_params, new_opt, metrics = optimizer.update(grads, opt_state, tree)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return params, new_opt, metrics

    return train_step
