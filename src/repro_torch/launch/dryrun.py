"""Dry run: place and cost every (arch x shape x mesh) cell on ``meta``.

For each cell the dry run:

1. builds the production mesh over the ``meta`` device (16x16 single-pod,
   or 2x16x16 multi-pod; ``launch/mesh.py``);
2. derives the parameter / optimizer / batch / cache partition specs and
   their placements (``distributed/sharding.py``);
3. runs the cell's step (a training step with AdamW or Adafactor, a
   prefill, or a decode step) at full width on ``meta`` tensors under the
   FLOP counter (``distributed/costing.py``): nothing is allocated on any
   device;
4. reports the bytes a device (arguments and outputs exactly from the
   placements; temp as the peak of live ``meta`` storage over the step
   divided by the devices, an estimate and not a compiler's figure), the
   FLOPs a device, and the collectives the placements imply;
5. prices the three roofline terms with a card's constants
   (``core/cost_model.py``, the H100 SXM's by default): compute = FLOPs a
   device / bf16 peak, memory = ``analytic_hbm_bytes`` / HBM bandwidth,
   collective = collective bytes a device / NVLink bandwidth.  The
   collective term assumes one NVLink domain: traffic across nodes is not
   priced.

The model is built with the ``dense-ref`` attention backend, as the
reference's dry run builds its own, so both count the same products.

Usage:
    python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] --json out.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.configs import SHAPES, get_config, get_shape, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.cost_model import H100_SXM
from repro_torch.distributed.costing import (
    analytic_hbm_bytes,
    collective_bytes,
    step_collectives,
    trace_step,
)
from repro_torch.distributed.sharding import (
    P,
    batch_pspecs,
    cache_pspecs,
    param_pspecs,
    placements,
    tree_leaves,
)
from repro_torch.launch.mesh import Mesh, MeshAxes, make_production_mesh
from repro_torch.models.param_tree import RefLeaf
from repro_torch.models.registry import (abstract_params, cache_specs,
                                         get_model, input_specs)
from repro_torch.training.optimizer import get_optimizer
from repro_torch.training.train_state import make_train_step

__all__ = ["CellReport", "Cell", "LONG_CONTEXT_ARCHS", "build_cell",
           "run_cell", "model_flops_for", "tree_bytes", "main"]

# archs whose quadratic attention rules out the 512k decode cell (the shape
# sheet's own rule); recorded as skip in the sweep
LONG_CONTEXT_ARCHS = ("zamba2-7b", "mamba2-370m")

NOTE = ("meta-device dry run: temp bytes are the peak of live meta storage "
        "over the step / devices (an estimate, not a compiler's figure); "
        "collectives are those the placements imply, priced over one NVLink "
        "domain (no cross-node traffic)")


@dataclasses.dataclass
class CellReport:
    arch: str
    shape: str
    mesh: str
    status: str                      # ok | skip | error
    note: str = ""
    compile_s: float = 0.0           # the meta step's wall time
    flops_per_device: float = 0.0    # traced, global / n_dev
    hbm_bytes_per_device: float = 0.0  # analytic minimal traffic
    hlo_flops_per_device: float = 0.0  # no compiler: 0
    hlo_bytes_per_device: float = 0.0
    collective_bytes: Optional[Dict[str, float]] = None
    collective_total: float = 0.0
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    temp_bytes: float = 0.0
    compute_term_s: float = 0.0
    memory_term_s: float = 0.0
    collective_term_s: float = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0
    model_flops_ratio: float = 0.0
    fits_hbm: bool = True
    product_flops_per_device: float = 0.0
    aux: Optional[Dict[str, float]] = None

    def to_dict(self):
        return dataclasses.asdict(self)


def tree_bytes(tree) -> float:
    """Bytes of every array leaf of ``tree`` (a :class:`RefLeaf` counts its
    stacked shape)."""
    def nbytes(x) -> float:
        if isinstance(x, RefLeaf):
            return math.prod(x.shape) * x.parts[0].element_size()
        return x.numel() * x.element_size()
    return float(sum(nbytes(x) for x in tree_leaves(
        tree, lambda x: isinstance(x, (RefLeaf, torch.Tensor)))))


def _placed_bytes(tree, place_tree) -> float:
    """Bytes one device holds of ``tree`` under ``place_tree`` (the same
    structure, :class:`Placement` leaves)."""
    is_leaf = lambda x: isinstance(x, (RefLeaf, torch.Tensor))  # noqa: E731
    leaves = tree_leaves(tree, is_leaf)
    places = tree_leaves(place_tree, lambda x: hasattr(x, "shard_bytes"))
    if len(leaves) != len(places):
        raise ValueError(f"{len(leaves)} leaves, {len(places)} placements")
    total = 0
    for x, pl in zip(leaves, places):
        dtype = x.parts[0].dtype if isinstance(x, RefLeaf) else x.dtype
        total += pl.shard_bytes(tuple(x.shape), dtype)
    return float(total)


def _should_skip(arch: str, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return ("full-attention arch: 512k decode requires sub-quadratic "
                "attention (shape-sheet rule)")
    return None


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for train, 2·N·D for inference (N = active params)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


@dataclasses.dataclass
class Cell:
    """A built cell: ``fn(*args)`` is its step on ``meta`` tensors;
    ``arg_trees`` the arguments as trees of leaves (the model as its
    reference leaves) and ``arg_places`` their placements;
    ``out_places(out)`` the placements of the step's output (a training
    step's is its updated arguments and its metrics); ``aux`` the
    reference's byte terms a device; ``collectives`` those the placements
    imply for one step."""

    cfg: Any
    shape: ShapeConfig
    fn: Any
    args: tuple
    arg_trees: tuple
    arg_places: tuple
    out_places: Any
    aux: Dict[str, float]
    collectives: list


def _logits_spec(shape: ShapeConfig, ax: MeshAxes, logits) -> P:
    """Logits ``[B, S, V]`` as the unembedding's hint places them: batch
    over the dp axes that divide it, vocab over ``model``."""
    spec = batch_pspecs(None, shape, {"x": logits}, ax)["x"]
    V = logits.shape[-1]
    m = ax.model if ax.model and V % ax.model_size == 0 else None
    return P(*spec[:-1], m)


def build_cell(arch: str, shape_name: Union[str, ShapeConfig], mesh: Mesh,
               strategy: str = "tp") -> Cell:
    """The cell's step, its arguments on ``meta`` and their placements.

    ``shape_name`` names a shape of ``SHAPES`` or is a :class:`ShapeConfig`;
    ``strategy``: ``"tp"`` (tensor parallelism over ``model``, FSDP over
    the data axes for models above ~8 GB of bf16 params) or ``"zero"``
    (ZeRO-3 pure DP: every axis carries batch)."""
    if strategy not in ("tp", "zero"):
        raise ValueError(f"strategy {strategy!r}: tp or zero")
    cfg = get_config(arch)
    shape = get_shape(shape_name) if isinstance(shape_name, str) else shape_name
    ax = MeshAxes(mesh)
    n_dev = mesh.size
    api = get_model(cfg, attn_backend="dense-ref")
    model = abstract_params(cfg)
    tree = api.ref_leaves(model)
    fsdp = cfg.param_count() * 2 > 8e9  # params above ~8 GB must shard 2D
    pspecs = param_pspecs(cfg, tree, ax, fsdp=fsdp, strategy=strategy)
    if strategy == "zero":
        ax = ax.as_pure_dp()        # batch over every axis; no TP axis
    param_bytes_dev = tree_bytes(tree) / n_dev
    tokens_dev = shape.tokens / n_dev
    pplace = placements(mesh, pspecs)
    colls = step_collectives(cfg, shape, ax, tree, pspecs)

    if shape.kind == "train":
        model.requires_grad_(True)
        tree = api.ref_leaves(model)
        opt = get_optimizer(cfg)
        ostate = opt.init(tree)
        ospecs = opt.state_pspecs(pspecs, tree)
        batch = input_specs(cfg, shape, abstract=True)
        bspecs = batch_pspecs(cfg, shape, batch, ax)
        if cfg.family == "moe":
            loss = lambda p, b: api.loss_fn(p, b, dp_groups=ax.dp_size)  # noqa: E731
        else:
            loss = api.loss_fn
        step = make_train_step(loss, opt, api.ref_leaves, grad_shardings=pplace)
        oplace = placements(mesh, ospecs)
        n_blocks = cfg.n_layers + cfg.n_encoder_layers
        aux = {
            "param_bytes_dev": param_bytes_dev,
            "opt_bytes_dev": tree_bytes(ostate) / n_dev,
            "stash_bytes_dev": n_blocks * tokens_dev * cfg.d_model * 2.0,
            "cache_bytes_dev": 0.0,
            "io_bytes_dev": tree_bytes(batch) / n_dev,
        }

        def out_places(out):
            _, _, metrics = out
            return (pplace, oplace, {k: placements(mesh, P()) for k in metrics})

        return Cell(cfg, shape, step, (model, ostate, batch),
                    (tree, ostate, batch),
                    (pplace, oplace, placements(mesh, bspecs)), out_places,
                    aux, colls)

    batch = input_specs(cfg, shape, abstract=True)
    bspecs = batch_pspecs(cfg, shape, batch, ax)
    if shape.kind == "prefill":
        max_len = shape.seq_len  # cache capacity = prompt length here
        if cfg.family == "moe":
            fn = lambda p, b: api.prefill(p, b, max_len, dp_groups=ax.dp_size)  # noqa: E731
        else:
            fn = lambda p, b: api.prefill(p, b, max_len)  # noqa: E731
        aux = {
            "param_bytes_dev": param_bytes_dev,
            "opt_bytes_dev": 0.0,
            "stash_bytes_dev": 2 * tokens_dev * cfg.d_model * 2.0,
            "cache_bytes_dev": 0.0,   # from the step's output (run_cell)
            "io_bytes_dev": tree_bytes(batch) / n_dev,
        }

        def out_places(out):
            logits, cache = out
            return (placements(mesh, _logits_spec(shape, ax, logits)),
                    placements(mesh, cache_pspecs(cfg, shape, cache, ax)))

        return Cell(cfg, shape, torch.no_grad()(fn), (model, batch),
                    (tree, batch), (pplace, placements(mesh, bspecs)),
                    out_places, aux, colls)

    # decode
    cache = cache_specs(cfg, shape, abstract=True)
    cplace = placements(mesh, cache_pspecs(cfg, shape, cache, ax))
    if cfg.family == "moe":
        fn = lambda p, t, c: api.decode_step(p, t, c, dp_groups=1)  # noqa: E731
    else:
        fn = api.decode_step
    aux = {
        "param_bytes_dev": param_bytes_dev,
        "opt_bytes_dev": 0.0,
        "stash_bytes_dev": 0.0,
        "cache_bytes_dev": tree_bytes(cache) / n_dev,
        "io_bytes_dev": tree_bytes(batch) / n_dev,
    }

    def out_places(out):
        logits, new_cache = out
        return (placements(mesh, _logits_spec(shape, ax, logits)),
                placements(mesh, cache_pspecs(cfg, shape, new_cache, ax)))

    return Cell(cfg, shape, torch.no_grad()(fn),
                (model, batch["token"], cache), (tree, batch["token"], cache),
                (pplace, placements(mesh, bspecs)["token"], cplace),
                out_places, aux, colls)


def _mesh_name(mesh: Mesh, strategy: str) -> str:
    name = "x".join(str(n) for n in mesh.devices.shape)
    return name + ("" if strategy == "tp" else f"+{strategy}")


def run_cell(arch: str, shape_name: Union[str, ShapeConfig],
             multi_pod: bool = False, mesh: Optional[Mesh] = None,
             verbose: bool = True, strategy: str = "tp",
             constants=H100_SXM) -> CellReport:
    """Build and cost one cell; an error becomes ``status="error"`` with
    its note, a skipped cell ``status="skip"``."""
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    name = shape_name if isinstance(shape_name, str) else shape_name.name
    mesh_name = _mesh_name(mesh, strategy)
    skip = _should_skip(arch, name)
    if skip:
        return CellReport(arch=arch, shape=name, mesh=mesh_name,
                          status="skip", note=skip)
    n_dev = mesh.size
    t0 = time.time()
    try:
        cell = build_cell(arch, shape_name, mesh, strategy=strategy)
        cfg, shape = cell.cfg, cell.shape
        arg_b = sum(_placed_bytes(a, p) for a, p in
                    zip(cell.arg_trees, cell.arg_places))
        out, trace = trace_step(cell.fn, *cell.args)
        dt = time.time() - t0
        aux = dict(cell.aux)
        if shape.kind == "prefill":
            aux["cache_bytes_dev"] = tree_bytes(out[1]) / n_dev
        out_tree = out
        if shape.kind == "train":  # the params are updated in place
            out_tree = (cell.arg_trees[0], out[1], out[2])
        out_b = sum(_placed_bytes(o, p) for o, p in
                    zip(out_tree, cell.out_places(out)))
        flops = trace.flops / n_dev
        byts = analytic_hbm_bytes(kind=shape.kind, **aux)
        coll, coll_total = collective_bytes(cell.collectives)
        compute_term = flops / constants.peak_bf16_flops
        memory_term = byts / constants.hbm_bandwidth
        collective_term = coll_total / constants.link_bandwidth
        terms = {"compute": compute_term, "memory": memory_term,
                 "collective": collective_term}
        bottleneck = max(terms, key=terms.get)
        tmp_b = trace.peak_bytes / n_dev
        mf = model_flops_for(cfg, shape)
        report = CellReport(
            arch=arch, shape=name, mesh=mesh_name, status="ok", note=NOTE,
            compile_s=dt, flops_per_device=flops, hbm_bytes_per_device=byts,
            collective_bytes=coll, collective_total=coll_total,
            argument_bytes=arg_b, output_bytes=out_b, temp_bytes=tmp_b,
            compute_term_s=compute_term, memory_term_s=memory_term,
            collective_term_s=collective_term, bottleneck=bottleneck,
            model_flops=mf,
            model_flops_ratio=(mf / (flops * n_dev)) if flops else 0.0,
            fits_hbm=(arg_b + out_b + tmp_b) <= constants.hbm_bytes,
            product_flops_per_device=trace.product_flops / n_dev, aux=aux)
        if verbose:
            print(f"[{arch} x {name} x {mesh_name}] OK step={dt:.1f}s "
                  f"flops/dev={flops:.3e} hbm_bytes/dev={byts:.3e} "
                  f"coll/dev={coll_total:.3e}")
            print(f"  bytes/dev: args={arg_b / 1e9:.2f}GB out={out_b / 1e9:.2f}GB "
                  f"temp~{tmp_b / 1e9:.2f}GB fits_hbm={report.fits_hbm}")
            print(f"  roofline terms (s): compute={compute_term:.4f} "
                  f"memory={memory_term:.4f} collective={collective_term:.4f} "
                  f"-> {bottleneck}-bound; model_flops_ratio="
                  f"{report.model_flops_ratio:.2f}")
        return report
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        note = f"{type(e).__name__}: {e}"
        if verbose:
            import traceback

            print(f"[{arch} x {name} x {mesh_name}] ERROR {note}")
            traceback.print_exc()
        return CellReport(arch=arch, shape=name, mesh=mesh_name,
                          status="error", note=note[:2000],
                          compile_s=time.time() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    reports = []
    for mp in meshes:
        mesh = make_production_mesh(multi_pod=mp)
        for arch in archs:
            for shape in shapes:
                reports.append(run_cell(arch, shape, multi_pod=mp, mesh=mesh))
    ok = sum(r.status == "ok" for r in reports)
    sk = sum(r.status == "skip" for r in reports)
    er = sum(r.status == "error" for r in reports)
    print(f"\n=== dry-run sweep: {ok} ok / {sk} skip / {er} error ===")
    if args.json:
        with open(args.json, "w") as f:
            json.dump([r.to_dict() for r in reports], f, indent=1)
        print(f"wrote {args.json}")
    return 0 if er == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
