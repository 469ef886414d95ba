"""The port's training path (``repro_torch.training``, ``data/pipeline.py``,
the families' ``loss_fn``, ``distributed/compression.py``) against the JAX
package's, on the CPU at reduced configs.

Both sides hold the same weights: the reference's ``init`` params cast to
fp32 (this image's CPU jax cannot run the bf16 LM path), carried over with
each family's ``params_from_arrays``; the batches are the step-keyed
pipeline's, from its seed.  The reference's functions are compiled with
XLA's excess precision off (``_xla_strict.strict_jit``), so that the
encoder-decoder's bf16 encoder rounds where its code says, as the port's
does.

* ``PipelineSpec`` batches are byte for byte the reference's;
* every family's loss within 1e-5 of the reference's, and each gradient
  leaf within 1e-4 of that leaf's largest magnitude, except the
  encoder-decoder's encoder leaves: the reference casts the source frames
  to bf16, so the encoder's activations and their cotangents are bf16 on
  both sides, and a cotangent whose fp32 value differs in the last bits
  (the two attentions' backward passes sum in other orders) rounds to a
  neighbouring bf16 value now and then; those leaves are held to 1.2e-2
  of their largest magnitude, just above the largest reading over eight
  seeds of the init and the batch (1.091e-2; 4.307e-3 at the seed used
  here).  At three of those eight seeds such a flip also reaches the
  decoder's leaves through cross-attention (up to 5.093e-3) and the loss
  (up to 1.954e-5 relative); the seed used here, fixed before that
  reading, shows neither; ``test_encdec_bf16_leaves_across_seeds`` holds
  every leaf of seeds 1-7 at 1.2e-2 and prints the readings;
* schedules at 1e-7; AdamW and Adafactor updates, given the same
  gradients, at 1e-6 (parameters are not held elementwise after a step of
  two implementations whose gradients differ in the last bits: at step 1
  AdamW moves a weight by ``lr * sign(g)``);
* ``microbatches=2``: the loss at 1e-5 and the accumulated gradients at
  1e-4 of each leaf's largest magnitude;
* ``Int8Compressor``'s q, scale and error buffers bit for bit;
* a 3-step trajectory's losses at 1e-5;
* restart bit for bit, async ≡ sync checkpoints, CRC corruption caught;
* checkpoints readable in both directions between the two packages;
* the card's backward of a bf16 product (``layers._ProductAcc``) run on
  the CPU: each cotangent within one bf16 rounding of the reference's
  ``dot_general`` transpose, and through a whole bf16 model within the
  card-vs-CPU gate of ``chip_smoke.py`` (2^-8 of the loss, 2e-2 of each
  gradient leaf's largest magnitude) of autograd through the widened
  operands.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig as RefShape  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data.pipeline import PipelineSpec as RefPipeline  # noqa: E402
from repro.distributed import compression as ref_comp  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.training import checkpoint as ref_ckpt  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training import train_state as ref_train_state  # noqa: E402
from repro.training.trainer import Trainer as RefTrainer  # noqa: E402
from repro.training.trainer import TrainerConfig as RefTrainerConfig  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.data.pipeline import PipelineSpec  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.models import (  # noqa: E402
    encdec, hybrid, layers, mamba2, moe, registry, transformer)
from repro_torch.models.param_tree import RefLeaf, flatten  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402
from repro_torch.training.train_state import (  # noqa: E402
    make_train_step, value_and_grad)
from repro_torch.training.trainer import Trainer, TrainerConfig  # noqa: E402
from _xla_strict import strict_jit  # noqa: E402

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


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_batches_byte_identical(arch):
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    shape = ShapeConfig("t", kind="train", **SHAPE)
    port = PipelineSpec(cfg, shape, seed=5)
    ref = RefPipeline(ref_cfg, RefShape("t", kind="train", **SHAPE), seed=5)
    for step, lo, hi in ((0, 0, None), (7, 1, 3)):
        a, b = port.batch(step, lo, hi), ref.batch(step, lo, hi)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    dev = port.device_batch(7)
    for k, v in port.batch(7).items():
        np.testing.assert_array_equal(dev[k].numpy(), v)
    assert not np.array_equal(port.batch(7)["tokens"], port.batch(8)["tokens"])


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(arch):
    cfg, ref_cfg, ref_params, _ = _case(arch)
    api = ref_registry.get_model(ref_cfg)
    fn = strict_jit(jax.value_and_grad(lambda p, b: api.loss_fn(p, b)))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    loss, grads = fn(ref_params, batch)
    return float(loss), _ref_flat(grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    cfg = _case(arch)[0]
    ref_loss, ref_grads = _ref_value_and_grad(arch)
    model = _port_model(arch)
    api = registry.get_model(cfg, attn_backend="dense-ref")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    tree = api.ref_leaves(model)
    loss, grads = value_and_grad(api.loss_fn, model, batch, tree)
    np.testing.assert_allclose(float(loss), ref_loss, **LOSS_TOL)
    _assert_leafwise(_stacked(grads), ref_grads, GRAD_REL,
                     BF16_LEAVES.get(arch, ()))


@functools.lru_cache(maxsize=None)
def _ref_encdec_value_and_grad():
    api = ref_registry.get_model(_case("seamless-m4t-medium")[1])
    return api, strict_jit(jax.value_and_grad(lambda p, b: api.loss_fn(p, b)))


@pytest.mark.parametrize("seed", range(1, 8))
def test_encdec_bf16_leaves_across_seeds(seed):
    """``BF16_GRAD_REL`` across seeds of the init and the batch (seed 0 is
    ``test_loss_and_gradients_match_reference``'s): every leaf within it of
    its largest magnitude, the decoder's too, which an encoder cotangent's
    rounding reaches through cross-attention at some seeds, and the loss
    within one bf16 rounding (2^-8) relative.  ``pytest -s`` prints each
    seed's largest readings."""
    arch = "seamless-m4t-medium"
    cfg = _case(arch)[0]
    ref_api, fn = _ref_encdec_value_and_grad()
    ref_params = jax.tree.map(lambda x: x.astype(jnp.float32),
                              ref_api.init(jax.random.key(seed)))
    batch = PipelineSpec(cfg, ShapeConfig("t", kind="train", **SHAPE),
                         seed=3 + seed).batch(0)
    ref_loss, ref_grads = fn(ref_params, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    ref_grads = _ref_flat(ref_grads)
    model = _from_arrays(cfg, _to_numpy(ref_params)).requires_grad_(True)
    api = registry.get_model(cfg, attn_backend="dense-ref")
    loss, grads = value_and_grad(api.loss_fn, model,
                                 {k: torch.from_numpy(v) for k, v in batch.items()},
                                 api.ref_leaves(model))
    rel_loss = abs(float(loss) / float(ref_loss) - 1)
    got = _stacked(grads)
    rel = {k: float(np.max(np.abs(got[k] - w))) / max(float(np.max(np.abs(w))), 1e-30)
           for k, w in ref_grads.items() if w.size}
    enc = max(v for k, v in rel.items() if k[0] in BF16_LEAVES[arch])
    dec = max(v for k, v in rel.items() if k[0] not in BF16_LEAVES[arch])
    print(f"seed {seed}: loss {rel_loss:.3e} relative; encoder leaves "
          f"{enc:.3e}, decoder leaves {dec:.3e} of their largest magnitude")
    assert rel_loss <= 2.0 ** -8
    _assert_leafwise(got, ref_grads, BF16_GRAD_REL)


def test_remat_changes_no_bit():
    """``cfg.remat`` (on by default) recomputes each block in the backward
    pass; without it the loss and gradients are the same bits."""
    cfg = _case("zamba2-7b")[0]
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        api = registry.get_model(c, attn_backend="dense-ref")
        model = _port_model("zamba2-7b")
        loss, grads = value_and_grad(api.loss_fn, model, batch,
                                     api.ref_leaves(model))
        out.append((loss, _stacked(grads)))
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][1]:
        np.testing.assert_array_equal(out[0][1][k], out[1][1][k])


@pytest.mark.parametrize("arch", ARCHS + ("kimi-k2-1t-a32b",))
def test_params_to_arrays_inverts_params_from_arrays(arch):
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    tree = _to_numpy(ref_registry.get_model(ref_cfg).init(jax.random.key(1)))
    fam = FAMILIES[cfg.family]
    model = fam.params_from_arrays(cfg, tree)
    back = fam.params_to_arrays(cfg, model)
    want = _ref_flat(tree)
    got = {k: v for k, v in flatten(back).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # the structure too, None subtrees included
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(_to_numpy(tree))


# ---------------------------------------------------------------------------
# schedules and optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cosine", "wsd"])
def test_schedules_match_reference(name):
    port = optimizer.get_schedule(name, 3e-4, 5, 40)
    ref = ref_opt.get_schedule(name, 3e-4, 5, 40)
    for step in range(0, 45):
        np.testing.assert_allclose(float(port(step)), float(ref(step)),
                                   rtol=1e-7, atol=1e-7)


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


@pytest.mark.parametrize("opt_name,arch", [("adamw", "internlm2-1.8b"),
                                           ("adamw", "zamba2-7b"),
                                           ("adafactor", "zamba2-7b"),
                                           ("adafactor", "deepseek-moe-16b")])
def test_optimizer_updates_match_reference(opt_name, arch):
    """Two steps from the same params, given the same gradients: the new
    params and the optimizer state at 1e-6 (stacked leaves decide decay
    and Adafactor's factoring, as in the reference)."""
    sched_p = optimizer.get_schedule("cosine", 1e-2, 1, 10)
    sched_r = ref_opt.get_schedule("cosine", 1e-2, 1, 10)
    if opt_name == "adamw":
        port_opt, ref = optimizer.AdamW(sched_p), ref_opt.AdamW(sched_r)
    else:
        port_opt = optimizer.Adafactor(sched_p, weight_decay=0.01)
        ref = ref_opt.Adafactor(sched_r, weight_decay=0.01)
    ref_params, _, leaves = _random_tree(arch, 0)
    ref_params = jax.tree.map(jnp.asarray, ref_params)
    p_state, r_state = port_opt.init(leaves), ref.init(ref_params)
    ref_update = jax.jit(ref.update)
    for step in range(2):
        ref_g, grads = _grads_like(arch, 10 + step)
        _, p_state, p_metrics = port_opt.update(grads, p_state, leaves)
        ref_params, r_state, r_metrics = ref_update(
            jax.tree.map(jnp.asarray, ref_g), r_state, ref_params)
        got, want = _stacked(leaves), _ref_flat(ref_params)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **UPDATE_TOL)
        np.testing.assert_allclose(float(p_metrics["lr"]),
                                   float(r_metrics["lr"]), rtol=1e-7)
        assert int(p_state["step"]) == int(r_state["step"]) == step + 1
        names = ("m", "v") if opt_name == "adamw" else ("vr", "vc")
        for name in names:
            want_s = _ref_flat(r_state[name])
            for k in want_s:
                got_s = p_state[name][k]
                got_s = (got_s.stacked() if isinstance(got_s, RefLeaf)
                         else got_s).numpy()
                np.testing.assert_allclose(got_s, want_s[k], **UPDATE_TOL)
        if opt_name == "adamw":
            np.testing.assert_allclose(float(p_metrics["grad_norm"]),
                                       float(r_metrics["grad_norm"]),
                                       rtol=1e-6)


class _Capture:
    """An optimizer that records the gradients it is given."""

    def __init__(self):
        self.grads = None

    def update(self, grads, state, params):
        self.grads = grads
        return params, state, {}


def test_microbatches_match_reference():
    arch = "internlm2-1.8b"
    cfg, ref_cfg, ref_params, _ = _case(arch)
    batch = _batch(cfg)
    ref_cap = _Capture()
    ref_step = ref_train_state.make_train_step(
        ref_registry.get_model(ref_cfg).loss_fn, ref_cap, microbatches=2)
    _, _, ref_metrics = ref_step(ref_params, None,
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    cap = _Capture()
    api = registry.get_model(cfg, attn_backend="dense-ref")
    step = make_train_step(api.loss_fn, cap, api.ref_leaves, microbatches=2)
    _, _, metrics = step(_port_model(arch), None,
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(ref_metrics["loss"]), **LOSS_TOL)
    got = _stacked(cap.grads)
    assert all(leaf.parts[0].dtype == torch.float32
               for leaf in cap.grads.values())
    _assert_leafwise(got, _ref_flat(ref_cap.grads), GRAD_REL)


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------


def test_int8_compressor_bitwise():
    arch = "zamba2-7b"
    comp, ref = compression.Int8Compressor(), ref_comp.Int8Compressor()
    _, _, leaves = _random_tree(arch, 0)
    error = comp.init(leaves)
    ref_error = ref.init(jax.tree.map(jnp.asarray, _case(arch)[3]))
    for step in range(2):
        ref_g, grads = _grads_like(arch, 20 + step)
        quant, error = comp.compress(grads, error)
        # op by op: under jit XLA contracts the error's ``target - q * scale``
        # into an fma, which the code does not ask for
        ref_quant, ref_error = ref.compress(jax.tree.map(jnp.asarray, ref_g),
                                            ref_error)
        ref_q = jax.tree.map(
            lambda t: (np.asarray(t.q), np.asarray(t.scale)), ref_quant,
            is_leaf=lambda x: isinstance(x, ref_comp._Quantized))
        ref_e = _ref_flat(ref_error)
        for key, leaf in grads.items():
            q, scale = quant[key]
            want_q, want_scale = functools.reduce(lambda n, k: n[k], key, ref_q)
            got_q = torch.stack(q).reshape(leaf.shape).numpy() if leaf.lead \
                else q[0].numpy()
            np.testing.assert_array_equal(got_q, want_q)
            assert got_q.dtype == np.int8
            assert scale.numpy().tobytes() == want_scale.tobytes()
            np.testing.assert_array_equal(error[key].stacked().numpy(),
                                          ref_e[key])
        deq = comp.decompress(quant, grads)
        ref_deq = _ref_flat(ref.decompress(ref_quant))
        for key in deq:
            np.testing.assert_array_equal(deq[key].stacked().numpy(),
                                          ref_deq[key])


def test_quantize_roundtrip_error_feedback():
    """``tests/test_fault_tolerance.py``'s: a quantization error of at most
    half a step, and error feedback's running mean near the true value."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    q, s = compression.quantize_int8(g)
    err = g - compression.dequantize_int8(q, s)
    assert float(err.abs().max()) <= float(s) * 0.5 + 1e-6
    comp = compression.Int8Compressor()
    tree = {("g",): RefLeaf((), [g])}
    e = comp.init(tree)
    total = torch.zeros_like(g)
    for _ in range(4):
        quant, e = comp.compress(tree, e)
        total = total + comp.decompress(quant, tree)[("g",)].parts[0]
    np.testing.assert_allclose((total / 4).numpy(), g.numpy(), atol=float(s))
    fp32_b, int8_b = comp.wire_bytes(tree)
    assert (fp32_b, int8_b) == (64 * 64 * 4, 64 * 64 + 4)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


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


def test_trajectory_matches_reference():
    """Three steps of each trainer from the same fp32 params and batches:
    the losses at 1e-5."""
    ref = _ref_trainer(None, 3)
    want = ref.fit()["loss"]
    port = _port_trainer(None, 3, cls=_TrainerFrom)
    port.arrays = _ref_init_arrays()
    got = port.fit()["loss"]
    np.testing.assert_allclose(got, want, **LOSS_TOL)


class TestRestartDeterminism:
    def test_resume_bitwise_identical(self, tmp_path):
        """Uninterrupted run ≡ crash after step 4 + restart (bf16 params, the
        port's own init): params bit for bit, losses continue."""
        full = _port_trainer(str(tmp_path / "full"), 6, ckpt_every=2)
        hist_full = full.fit()
        crash = str(tmp_path / "crash")
        _port_trainer(crash, 6, ckpt_every=2, stop_after=4).fit()
        resumed = _port_trainer(crash, 6, ckpt_every=2)
        hist_res = resumed.fit(resume=True)
        a, b = dict(full.params.named_parameters()), dict(
            resumed.params.named_parameters())
        assert a[next(iter(a))].dtype == torch.bfloat16
        for name in a:
            assert torch.equal(a[name], b[name]), name
        assert hist_res["step"][0] == 4
        np.testing.assert_allclose(hist_full["loss"][4:], hist_res["loss"],
                                   rtol=1e-6)


class TestCheckpoint:
    def test_roundtrip_and_keeps_latest(self, tmp_path):
        tree = {"a": torch.arange(12.0).reshape(3, 4),
                "b": {"c": torch.ones((2,), dtype=torch.int32),
                      "d": torch.arange(6.0).to(torch.bfloat16)}}
        for s in (1, 2, 3):
            ckpt.save(str(tmp_path), s, tree)
        assert ckpt.latest_steps(str(tmp_path)) == [1, 2, 3]
        like = {"a": torch.zeros(3, 4),
                "b": {"c": torch.zeros(2, dtype=torch.int32),
                      "d": torch.zeros(6, dtype=torch.bfloat16)}}
        restored, step = ckpt.restore(str(tmp_path), like)
        assert step == 3
        assert torch.equal(like["a"], tree["a"])
        assert torch.equal(like["b"]["c"], tree["b"]["c"])
        assert torch.equal(like["b"]["d"], tree["b"]["d"])
        assert restored["a"] is like["a"]

    def test_crc_detects_corruption(self, tmp_path):
        tree = {"w": torch.ones((8, 8))}
        path = ckpt.save(str(tmp_path), 1, tree)
        for name in os.listdir(path):
            if name.endswith(".npy"):
                arr = np.load(os.path.join(path, name))
                arr[0] += 1
                np.save(os.path.join(path, name), arr)
        with pytest.raises(IOError):
            ckpt.restore(str(tmp_path), tree)

    def test_async_equals_sync(self, tmp_path):
        t_sync = _port_trainer(str(tmp_path / "s"), 4, ckpt_every=2)
        t_sync.fit()
        t_async = _port_trainer(str(tmp_path / "a"), 4, ckpt_every=2,
                                async_ckpt=True)
        t_async.fit()
        for step in (2, 4):
            a, _ = ckpt.load_arrays(str(tmp_path / "s"), step)
            b, _ = ckpt.load_arrays(str(tmp_path / "a"), step)
            fa, fb = flatten(a), flatten(b)
            assert set(fa) == set(fb)
            for k in fa:
                np.testing.assert_array_equal(fa[k], fb[k])

    def test_reference_checkpoint_restores_in_the_port(self, tmp_path):
        """The reference's trainer writes; the port reads the params through
        ``params_from_arrays`` and restores the whole state in place."""
        ref = _ref_trainer(str(tmp_path), 2, ckpt_every=2)
        ref.fit()
        arrays, step = ckpt.load_arrays(str(tmp_path))
        assert step == 2
        cfg = get_config("llama3.2-1b").reduced()
        model = transformer.params_from_arrays(cfg, arrays["params"],
                                               dtype=torch.float32)
        want = _ref_flat(ref.params)
        got = _stacked(transformer.ref_leaves(model))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        port = _port_trainer(None, 2)
        params, opt_state, _ = port.init_state()
        ckpt.restore(str(tmp_path), port.state_tree(params, opt_state))
        ref_m = _ref_flat(ref.opt_state["m"])
        for k, leaf in opt_state["m"].items():
            np.testing.assert_array_equal(leaf.stacked().numpy(), ref_m[k])
        assert int(opt_state["step"]) == 2

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_port_checkpoint_restores_in_the_reference(self, tmp_path, dtype):
        if dtype == "float32":
            port = _port_trainer(str(tmp_path), 2, cls=_TrainerFrom,
                                 ckpt_every=2)
            port.arrays = _ref_init_arrays()
            ref = _ref_trainer(None, 2)
        else:
            port = _port_trainer(str(tmp_path), 2, ckpt_every=2)
            ref = RefTrainer(ref_get_config("llama3.2-1b").reduced(),
                             RefShape("t", 16, 4, "train"),
                             RefTrainerConfig(total_steps=2))
        port.fit()
        params, opt_state, _ = ref.init_state()
        state, step = ref_ckpt.restore(str(tmp_path),
                                       {"params": params, "opt": opt_state})
        assert step == 2
        leaves = transformer.ref_leaves(port.params)
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                state["params"])[0]:
            key = tuple(str(p.key) for p in path)
            assert str(leaf.dtype) == dtype
            np.testing.assert_array_equal(
                np.asarray(leaf, np.float32),
                leaves[key].stacked().detach().float().numpy())
        want_v = _stacked(port.opt_state["v"])
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                state["opt"]["v"])[0]:
            key = tuple(str(p.key) for p in path)
            np.testing.assert_array_equal(np.asarray(leaf), want_v[key])
        assert int(state["opt"]["step"]) == 2


def test_gradient_compression_trains():
    """``tests/test_fault_tolerance.py``'s convergence check: the int8 path's
    loss drops and stays near the uncompressed path's."""
    hist_fp = _port_trainer(None, 8).fit()
    comp = _port_trainer(None, 8, compress_grads=True)
    hist_q8 = comp.fit()
    assert hist_q8["loss"][-1] < hist_q8["loss"][0]
    assert abs(hist_q8["loss"][-1] - hist_fp["loss"][-1]) < \
        0.1 * hist_fp["loss"][-1] + 0.35
    fp32_b, int8_b = compression.Int8Compressor.wire_bytes(
        comp.model.ref_leaves(comp.params))
    assert int8_b < 0.27 * fp32_b


def test_trainer_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3.2-1b").reduced()
    shape = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
    with pytest.raises(RuntimeError, match="CUDA device"):
        Trainer(cfg, shape, TrainerConfig())
    Trainer(cfg, shape, TrainerConfig(), device="cpu")


def test_non_finite_loss_raises():
    port = _port_trainer(None, 2, cls=_TrainerFrom)
    arrays = _ref_init_arrays()
    arrays["embed"] = arrays["embed"] * np.float32("nan")
    port.arrays = arrays
    with pytest.raises(FloatingPointError, match="step 0"):
        port.fit()


# ---------------------------------------------------------------------------
# the card's backward of a bf16 product, run on the CPU
# ---------------------------------------------------------------------------


class _WidenedProductAcc(layers._ProductAcc):
    """``layers._ProductAcc`` with the operands widened to fp32 (exact for
    bf16) in its forward, in place of cuBLAS's ``out_dtype`` product, which
    the CPU lacks; its backward, under test, is the card's."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.matmul(x.to(torch.float32), w.to(torch.float32))


@pytest.mark.parametrize("x_shape,w_shape", [((37, 64), (64, 64)),
                                             ((3, 19, 16), (3, 16, 24))],
                         ids=["mm-square", "bmm"])
def test_product_acc_backward_is_the_dot_general_transpose(x_shape, w_shape):
    """Each cotangent of a bf16 product with an fp32 output is the
    reference's transpose of ``dot_general``: the fp32 cotangent against the
    other operand in fp32, rounded once to its operand's dtype (bf16)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = rng.standard_normal(w_shape).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    wb = torch.from_numpy(w).to(torch.bfloat16).requires_grad_(True)
    y = _WidenedProductAcc.apply(xb, wb)
    assert y.dtype == torch.float32
    g = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    y.backward(torch.from_numpy(g))
    # the operands as the card holds them (bf16), widened exactly
    xr = jnp.asarray(xb.detach().float().numpy())
    wr = jnp.asarray(wb.detach().float().numpy())
    _, vjp = jax.vjp(jnp.matmul, xr, wr)
    for got, want in zip((xb.grad, wb.grad), vjp(jnp.asarray(g))):
        assert got.dtype == torch.bfloat16
        want = torch.from_numpy(np.asarray(want))
        torch.testing.assert_close(
            got.float(), want.to(torch.bfloat16).float(), rtol=2.0 ** -8,
            atol=2.0 ** -8 * float(want.abs().max()))


@pytest.mark.parametrize("arch", ("internlm2-1.8b", "deepseek-moe-16b"))
def test_product_acc_backward_through_a_bf16_model(arch, monkeypatch):
    """A bf16 model's loss and gradients with every bf16 product
    differentiated by ``_ProductAcc`` (the card's route) against autograd
    through the widened operands (the CPU's), at ``chip_smoke.py``'s bf16
    card-vs-CPU gate."""
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=2)
    api = registry.get_model(cfg, attn_backend="dense-ref")
    model = api.init(torch.Generator().manual_seed(0)).requires_grad_(True)
    assert torch.bfloat16 in {p.dtype for p in model.parameters()}
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss_w, g_w = value_and_grad(api.loss_fn, model, batch,
                                 api.ref_leaves(model))
    widened_mm, widened_bmm = layers.matmul_acc, layers.bmm_acc
    routed = []

    def matmul_acc(x, w):
        if x.dtype == w.dtype == torch.bfloat16:
            routed.append(1)
            y = _WidenedProductAcc.apply(x.reshape(-1, x.shape[-1]), w)
            return y.reshape(*x.shape[:-1], w.shape[-1])
        return widened_mm(x, w)

    def bmm_acc(x, w):
        if x.dtype == w.dtype == torch.bfloat16:
            routed.append(1)
            return _WidenedProductAcc.apply(x, w)
        return widened_bmm(x, w)

    monkeypatch.setattr(layers, "matmul_acc", matmul_acc)
    monkeypatch.setattr(layers, "bmm_acc", bmm_acc)
    loss_p, g_p = value_and_grad(api.loss_fn, model, batch,
                                 api.ref_leaves(model))
    assert routed
    assert abs(float(loss_p) / float(loss_w) - 1) <= 2.0 ** -8
    for key, leaf in g_w.items():
        want = leaf.stacked()
        got = g_p[key].stacked()
        assert got.dtype == want.dtype, key
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2e-2 * max(float(want.float().abs().max()), 1e-30), \
            (key, err)
