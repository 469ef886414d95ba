"""``strict_jit``: ``jax.jit`` compiled with XLA's excess precision off.

By default XLA may keep bf16 intermediates of a fused computation in fp32
(``xla_allow_excess_precision``), skipping roundings the code asks for.
The encoder of the reference's encoder-decoder runs bf16 activations, so
the port, which rounds where the code says, is held to the reference
compiled this way (``tests/test_torch_encdec.py``,
``tests/test_torch_continuous_batching.py``)."""

import jax
import jax.numpy as jnp

STRICT = {"xla_allow_excess_precision": False}


def strict_jit(fn, static_argnums=()):
    """``jax.jit(fn)``, compiled with XLA's excess precision off, once per
    value of the static arguments and shapes and dtypes of the others."""
    jitted = jax.jit(fn, static_argnums=static_argnums)
    compiled = {}

    def call(*args):
        dynamic = [a for i, a in enumerate(args) if i not in static_argnums]
        leaves, tree = jax.tree_util.tree_flatten(dynamic)
        key = (tuple(args[i] for i in static_argnums), tree,
               tuple((jnp.shape(x), jnp.result_type(x)) for x in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(compiler_options=STRICT)
        return compiled[key](*dynamic)
    return call
