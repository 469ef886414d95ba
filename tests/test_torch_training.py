"""The port's training path (``repro_torch.training``, ``data/pipeline.py``,
the families' ``loss_fn``) against the JAX package's, on the CPU at
reduced configs: the loss and its gradients.  The optimizers, the
compression, the checkpoints and the bf16 backward are in
``tests/test_torch_training_{optim,compression,checkpoint,bf16}.py``.

Both sides hold the same weights: the reference's ``init`` params cast to
fp32 (this image's CPU jax cannot run the bf16 LM path), carried over with
each family's ``params_from_arrays``; the batches are the step-keyed
pipeline's, from its seed.  The reference's functions are compiled with
XLA's excess precision off (``_xla_strict.strict_jit``), so that the
encoder-decoder's bf16 encoder rounds where its code says, as the port's
does.  The shared setup is ``tests/_torch_training_common.py``.

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
  reading, shows neither; ``test_encdec_bf16_leaves_across_seeds``
  (``tests/test_torch_training_bf16.py``) holds every leaf of seeds 1-7
  at 1.2e-2 and prints the readings;
* ``params_to_arrays`` inverts ``params_from_arrays``; schedules at 1e-7;
  the trainer's CUDA default raises without a card.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.configs import ShapeConfig as RefShape  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data.pipeline import PipelineSpec as RefPipeline  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.data.pipeline import PipelineSpec  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.param_tree import flatten  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402
from repro_torch.training.train_state import value_and_grad  # noqa: E402
from repro_torch.training.trainer import Trainer, TrainerConfig  # noqa: E402
from _torch_training_common import (  # noqa: E402
    ARCHS,
    _assert_leafwise,
    _batch,
    BF16_LEAVES,
    _case,
    FAMILIES,
    GRAD_REL,
    LOSS_TOL,
    _port_model,
    _ref_flat,
    _ref_value_and_grad,
    SHAPE,
    _stacked,
    _to_numpy,
)


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
    dev = port.device_batch(7, device="cpu")
    for k, v in port.batch(7).items():
        np.testing.assert_array_equal(dev[k].numpy(), v)
    assert not np.array_equal(port.batch(7)["tokens"], port.batch(8)["tokens"])


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


@pytest.mark.parametrize("name", ["cosine", "wsd"])
def test_schedules_match_reference(name):
    port = optimizer.get_schedule(name, 3e-4, 5, 40)
    ref = ref_opt.get_schedule(name, 3e-4, 5, 40)
    for step in range(0, 45):
        np.testing.assert_allclose(float(port(step)), float(ref(step)),
                                   rtol=1e-7, atol=1e-7)


def test_trainer_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3.2-1b").reduced()
    shape = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
    with pytest.raises(RuntimeError, match="CUDA device"):
        Trainer(cfg, shape, TrainerConfig())
    Trainer(cfg, shape, TrainerConfig(), device="cpu")
