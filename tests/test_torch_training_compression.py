"""The port's int8 gradient compression (``distributed/compression.py``)
against the JAX package's, on the CPU.

Both sides hold the same weights: the reference's ``init`` params cast to
fp32 (this image's CPU jax cannot run the bf16 LM path), carried over with
each family's ``params_from_arrays``; the batches are the step-keyed
pipeline's, from its seed.  The reference's functions are compiled with
XLA's excess precision off (``_xla_strict.strict_jit``), so that the
encoder-decoder's bf16 encoder rounds where its code says, as the port's
does.  The shared setup is ``tests/_torch_training_common.py``.

* ``Int8Compressor``'s q, scale and error buffers bit for bit (the
  reference op by op: under jit XLA fuses the error's ``target - q *
  scale`` into an fma);
* the quantize round trip with error feedback;
* a trainer with compression on trains.
"""

import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.distributed import compression as ref_comp  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.models.param_tree import RefLeaf  # noqa: E402
from _torch_training_common import (  # noqa: E402
    _case,
    _grads_like,
    _port_trainer,
    _random_tree,
    _ref_flat,
)


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
