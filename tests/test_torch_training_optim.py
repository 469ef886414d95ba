"""The port's optimizers and training steps against the JAX package's, on
the CPU at reduced configs.

Both sides hold the same weights: the reference's ``init`` params cast to
fp32 (this image's CPU jax cannot run the bf16 LM path), carried over with
each family's ``params_from_arrays``; the batches are the step-keyed
pipeline's, from its seed.  The reference's functions are compiled with
XLA's excess precision off (``_xla_strict.strict_jit``), so that the
encoder-decoder's bf16 encoder rounds where its code says, as the port's
does.  The shared setup is ``tests/_torch_training_common.py``.

* AdamW and Adafactor updates, given the same gradients, at 1e-6
  (parameters are not held elementwise after a step of two
  implementations whose gradients differ in the last bits: at step 1
  AdamW moves a weight by ``lr * sign(g)``);
* ``microbatches=2``: the loss at 1e-5 and the accumulated gradients at
  1e-4 of each leaf's largest magnitude;
* a 3-step trajectory's losses at 1e-5.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as ref_registry  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training import train_state as ref_train_state  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.param_tree import RefLeaf  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402
from repro_torch.training.train_state import make_train_step  # noqa: E402
from _torch_training_common import (  # noqa: E402
    _assert_leafwise,
    _batch,
    _Capture,
    _case,
    GRAD_REL,
    _grads_like,
    LOSS_TOL,
    _port_model,
    _port_trainer,
    _random_tree,
    _ref_flat,
    _ref_init_arrays,
    _ref_trainer,
    _stacked,
    _TrainerFrom,
    UPDATE_TOL,
)


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


def test_trajectory_matches_reference():
    """Three steps of each trainer from the same fp32 params and batches:
    the losses at 1e-5."""
    ref = _ref_trainer(None, 3)
    want = ref.fit()["loss"]
    port = _port_trainer(None, 3, cls=_TrainerFrom)
    port.arrays = _ref_init_arrays()
    got = port.fit()["loss"]
    np.testing.assert_allclose(got, want, **LOSS_TOL)
