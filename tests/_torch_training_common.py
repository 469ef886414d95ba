"""Shared setup of the port's training tests (``tests/test_torch_training*.py``):
the reduced configs on the reference's fp32-cast params, the step-keyed
batches, the leafwise gradient check, and the reference's and the port's
trainers and value-and-grad functions the tests compare."""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import ShapeConfig as RefShape
from repro.configs import get_config as ref_get_config
from repro.models import registry as ref_registry
from repro.training.trainer import Trainer as RefTrainer
from repro.training.trainer import TrainerConfig as RefTrainerConfig
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data.pipeline import PipelineSpec
from repro_torch.models import (
    encdec, hybrid, layers, mamba2, moe, registry, transformer)
from repro_torch.training.trainer import Trainer, TrainerConfig
from _xla_strict import strict_jit

FAMILIES = {"dense": transformer, "vlm": transformer, "moe": moe,
            "ssm": mamba2, "hybrid": hybrid, "encdec": encdec}
ARCHS = ("internlm2-1.8b", "internvl2-2b", "deepseek-moe-16b", "mamba2-370m",
         "zamba2-7b", "seamless-m4t-medium")
SHAPE = dict(seq_len=16, global_batch=4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4
# leaves whose cotangents pass through bf16 activations: the encdec encoder
BF16_GRAD_REL = 1.2e-2
BF16_LEAVES = {"seamless-m4t-medium": ("enc_blocks", "ln_enc")}
UPDATE_TOL = dict(rtol=1e-6, atol=1e-6)


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _from_arrays(cfg, tree, dtype=torch.float32):
    fam = FAMILIES[cfg.family]
    return fam.params_from_arrays(cfg, tree, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _case(arch):
    """(port cfg, reference cfg, reference fp32 params, their numpy tree)."""
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    ref_params = jax.tree.map(lambda x: x.astype(jnp.float32),
                              ref_registry.get_model(ref_cfg).init(
                                  jax.random.key(0)))
    return cfg, ref_cfg, ref_params, _to_numpy(ref_params)


def _port_model(arch, dtype=torch.float32):
    cfg, _, _, arrays = _case(arch)
    return _from_arrays(cfg, arrays, dtype).requires_grad_(True)


def _batch(cfg, step=0):
    spec = PipelineSpec(cfg, ShapeConfig("t", kind="train", **SHAPE), seed=3)
    return spec.batch(step)


def _stacked(tree_of_leaves):
    """{path: numpy} from {path: RefLeaf}."""
    return {k: np.asarray(leaf.stacked().detach().float())
            for k, leaf in tree_of_leaves.items()}


def _ref_flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(str(p.key) for p in path)] = np.asarray(leaf, np.float32)
    return out


def _assert_leafwise(got, want, rel, bf16_roots=()):
    """Each leaf within ``rel`` of its largest magnitude (leaves under
    ``bf16_roots`` within ``BF16_GRAD_REL``)."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for key in want:
        tol = BF16_GRAD_REL if key[0] in bf16_roots else rel
        scale = float(np.max(np.abs(want[key]))) if want[key].size else 0.0
        err = float(np.max(np.abs(got[key] - want[key]))) if want[key].size else 0.0
        assert err <= tol * max(scale, 1e-30), (key, err, scale)


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(arch):
    cfg, ref_cfg, ref_params, _ = _case(arch)
    api = ref_registry.get_model(ref_cfg)
    fn = strict_jit(jax.value_and_grad(lambda p, b: api.loss_fn(p, b)))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    loss, grads = fn(ref_params, batch)
    return float(loss), _ref_flat(grads)


@functools.lru_cache(maxsize=None)
def _ref_encdec_value_and_grad():
    api = ref_registry.get_model(_case("seamless-m4t-medium")[1])
    return api, strict_jit(jax.value_and_grad(lambda p, b: api.loss_fn(p, b)))


def _random_tree(arch, seed):
    """A reference-shaped tree of fp32 values (params or gradients) and the
    port's RefLeaf tree over a model holding the same values."""
    cfg = _case(arch)[0]
    rng = np.random.default_rng(seed)
    arrays = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        _case(arch)[3])
    model = _from_arrays(cfg, arrays)
    leaves = registry.get_model(cfg, attn_backend="dense-ref").ref_leaves(model)
    return arrays, model, leaves


def _grads_like(arch, seed, scale=1e-2):
    arrays, model, leaves = _random_tree(arch, seed)
    grads = {k: leaf.map(lambda p: p.detach() * scale)
             for k, leaf in leaves.items()}
    return jax.tree.map(lambda a: a * np.float32(scale), arrays), grads


class _Capture:
    """An optimizer that records the gradients it is given."""

    def __init__(self):
        self.grads = None

    def update(self, grads, state, params):
        self.grads = grads
        return params, state, {}


class _RefTrainerF32(RefTrainer):
    """The reference's trainer on fp32-cast params (its bf16 dots do not run
    on this image's CPU jax)."""

    def init_state(self):
        params, opt_state, error = super().init_state()
        params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
        opt_state = self.optimizer.init(params)
        error = self.compressor.init(params) if self.compressor else None
        return params, opt_state, error


class _TrainerFrom(Trainer):
    """The port's trainer starting from given reference arrays (fp32)."""

    arrays = None

    def init_state(self):
        fam = FAMILIES[self.cfg.family]
        params = fam.params_from_arrays(self.cfg, self.arrays,
                                        dtype=torch.float32,
                                        device=self.device).requires_grad_(True)
        tree = self.model.ref_leaves(params)
        return (params, self.optimizer.init(tree),
                self.compressor.init(tree) if self.compressor else None)


def _ref_trainer(tmp, steps, arch="llama3.2-1b", **kw):
    cfg = ref_get_config(arch).reduced()
    shape = RefShape("t", seq_len=16, global_batch=4, kind="train")
    return _RefTrainerF32(cfg, shape, RefTrainerConfig(
        total_steps=steps, ckpt_dir=tmp, **kw), seed=0)


def _port_trainer(tmp, steps, arch="llama3.2-1b", cls=Trainer, seed=0, **kw):
    cfg = get_config(arch).reduced()
    shape = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
    return cls(cfg, shape, TrainerConfig(total_steps=steps, ckpt_dir=tmp, **kw),
               seed=seed, device="cpu")


def _ref_init_arrays(arch="llama3.2-1b"):
    ref_cfg = ref_get_config(arch).reduced()
    params = ref_registry.get_model(ref_cfg).init(jax.random.key(0))
    return _to_numpy(jax.tree.map(lambda x: x.astype(jnp.float32), params))


class _WidenedProductAcc(layers._ProductAcc):
    """``layers._ProductAcc`` with the operands widened to fp32 (exact for
    bf16) in its forward, in place of cuBLAS's ``out_dtype`` product, which
    the CPU lacks; its backward, under test, is the card's."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.matmul(x.to(torch.float32), w.to(torch.float32))
