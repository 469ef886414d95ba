"""The port's training in bf16 against the JAX package's, on the CPU at
reduced configs.

Both sides hold the same weights: the reference's ``init`` params cast to
fp32 (this image's CPU jax cannot run the bf16 LM path), carried over with
each family's ``params_from_arrays``; the batches are the step-keyed
pipeline's, from its seed.  The reference's functions are compiled with
XLA's excess precision off (``_xla_strict.strict_jit``), so that the
encoder-decoder's bf16 encoder rounds where its code says, as the port's
does.  The shared setup is ``tests/_torch_training_common.py``.

* the encoder-decoder's leaves at seeds 1-7 within 1.2e-2 of each leaf's
  largest magnitude (the bf16 encoder's cotangents; see
  ``tests/test_torch_training.py``), the readings printed;
* ``cfg.remat`` changes no bit of the loss or the gradients;
* the card's backward of a bf16 product (``layers._ProductAcc``) run on
  the CPU: each cotangent within one bf16 rounding of the reference's
  ``dot_general`` transpose, and through a whole bf16 model within the
  card-vs-CPU gate of ``chip_smoke.py`` (2^-8 of the loss, 2e-2 of each
  gradient leaf's largest magnitude) of autograd through the widened
  operands;
* a non-finite loss raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.data.pipeline import PipelineSpec  # noqa: E402
from repro_torch.models import layers, registry  # noqa: E402
from repro_torch.training.train_state import value_and_grad  # noqa: E402
from _torch_training_common import (  # noqa: E402
    _assert_leafwise,
    _batch,
    BF16_GRAD_REL,
    BF16_LEAVES,
    _case,
    _from_arrays,
    _port_model,
    _port_trainer,
    _ref_encdec_value_and_grad,
    _ref_flat,
    _ref_init_arrays,
    SHAPE,
    _stacked,
    _to_numpy,
    _TrainerFrom,
    _WidenedProductAcc,
)


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


def test_non_finite_loss_raises():
    port = _port_trainer(None, 2, cls=_TrainerFrom)
    arrays = _ref_init_arrays()
    arrays["embed"] = arrays["embed"] * np.float32("nan")
    port.arrays = arrays
    with pytest.raises(FloatingPointError, match="step 0"):
        port.fit()
