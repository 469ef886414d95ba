"""Training loop with checkpoint/restart, deterministic data, and optional
gradient compression (the reference's ``Trainer``).

``Trainer.fit`` runs steps from the last checkpoint (or 0) to
``total_steps``.  Restartability contract: (params, opt_state) from the
checkpoint + the step-keyed pipeline ⇒ resuming after a crash reproduces
the exact same parameter trajectory, given deterministic kernels (on the
card: ``torch.use_deterministic_algorithms(True)`` with
``CUBLAS_WORKSPACE_CONFIG`` set before the first cuBLAS call; the
embedding's backward otherwise adds in an order that varies).

It runs on ``device="cuda"`` unless constructed with ``device="cpu"``; the
default raises where no card is present.  The parameters are the family's
module with its gradients switched on; the optimizer state and the
checkpoints are keyed by the reference's param tree
(``models/param_tree.py``), so a checkpoint names its leaves as the
reference's does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.backends import attention_backend_for
from repro_torch.data.pipeline import PipelineSpec
from repro_torch.distributed.compression import Int8Compressor
from repro_torch.models.param_tree import nest
from repro_torch.models.registry import get_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import get_optimizer
from repro_torch.training.train_state import make_train_step, value_and_grad

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 20
    ckpt_every: int = 5
    ckpt_dir: Optional[str] = None
    base_lr: float = 3e-4
    warmup: int = 2
    microbatches: int = 1
    compress_grads: bool = False
    log_every: int = 1
    async_ckpt: bool = False
    stop_after: int = 0          # crash simulation: stop early (0 = run all)


class Trainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 tcfg: TrainerConfig, seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer runs on a CUDA device by default and none is "
                "available; pass Trainer(..., device='cpu') to train on the CPU")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"Trainer runs on cuda or cpu, not {device!r}")
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg
        # training decodes nothing; the backend is the one serving would use
        self.model = get_model(cfg, attention_backend_for(None, self.device))
        self.pipeline = PipelineSpec(cfg, shape, seed=seed)
        self.optimizer = get_optimizer(cfg, total_steps=tcfg.total_steps,
                                       base_lr=tcfg.base_lr, warmup=tcfg.warmup)
        self.compressor = Int8Compressor() if tcfg.compress_grads else None
        self.seed = seed
        self._build_step()

    def _build_step(self):
        loss_fn, leaves = self.model.loss_fn, self.model.ref_leaves
        if self.compressor is not None:
            comp = self.compressor

            def step(params, opt_state, error, batch):
                tree = leaves(params)
                loss, grads = value_and_grad(loss_fn, params, batch, tree)
                quant, error = comp.compress(grads, error)
                grads = comp.decompress(quant, tree)
                _, new_o, metrics = self.optimizer.update(grads, opt_state,
                                                          tree)
                metrics = dict(metrics)
                metrics["loss"] = loss
                return params, new_o, error, metrics

            self.train_step = step
        else:
            self.train_step = make_train_step(
                loss_fn, self.optimizer, leaves,
                microbatches=self.tcfg.microbatches)

    def init_state(self):
        """(params, opt_state, error): the family's ``init`` from ``seed`` on
        the device, its gradients switched on."""
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        params = self.model.init(generator).requires_grad_(True)
        tree = self.model.ref_leaves(params)
        opt_state = self.optimizer.init(tree)
        error = self.compressor.init(tree) if self.compressor else None
        return params, opt_state, error

    def state_tree(self, params, opt_state) -> Dict[str, Any]:
        """``{"params", "opt"}`` in the reference's tree, over the live
        tensors: what a checkpoint holds."""
        opt = {k: nest(v) if isinstance(v, dict) else v
               for k, v in opt_state.items()}
        return {"params": nest(self.model.ref_leaves(params)), "opt": opt}

    def fit(self, resume: bool = True) -> Dict[str, list]:
        params, opt_state, error = self.init_state()
        start_step = 0
        saver = None
        if self.tcfg.ckpt_dir:
            os.makedirs(self.tcfg.ckpt_dir, exist_ok=True)
            if resume and ckpt.latest_steps(self.tcfg.ckpt_dir):
                _, start_step = ckpt.restore(
                    self.tcfg.ckpt_dir, self.state_tree(params, opt_state))
            if self.tcfg.async_ckpt:
                saver = ckpt.AsyncCheckpointer(self.tcfg.ckpt_dir)

        history: Dict[str, list] = {"step": [], "loss": []}
        stop = self.tcfg.stop_after or self.tcfg.total_steps
        try:
            for step in range(start_step, min(stop, self.tcfg.total_steps)):
                batch = self.pipeline.device_batch(step, self.device)
                if self.compressor is not None:
                    params, opt_state, error, metrics = self.train_step(
                        params, opt_state, error, batch)
                else:
                    params, opt_state, metrics = self.train_step(
                        params, opt_state, batch)
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}")
                history["step"].append(step)
                history["loss"].append(loss)
                done = step + 1
                if self.tcfg.ckpt_dir and (done % self.tcfg.ckpt_every == 0
                                           or done == self.tcfg.total_steps):
                    tree = self.state_tree(params, opt_state)
                    if saver is not None:
                        saver.save_async(done, tree)
                    else:
                        ckpt.save(self.tcfg.ckpt_dir, done, tree)
        finally:
            if saver is not None:
                saver.close()
        self.params = params
        self.opt_state = opt_state
        return history
