"""The configuration keys the port has and the JAX reference has not, at
the values that route and cache as the reference does: a port
``ModelConfig`` equals the reference's field for field, plus these.
``PORT_ONLY`` lists every key the port has and the reference has not, so
that no key of the port drops out of the comparison unseen: a key added
to the port's ``ModelConfig`` alone goes here too."""

import dataclasses

# models/moe.py: a softmax over the k chosen logits, an fp32 decode cache
PORT_ONLY = {"moe_norm_topk_prob": True, "moe_cache_dtype": "float32"}


def as_port(ref_cfg) -> dict:
    """``dataclasses.asdict`` of a reference config with the port's own
    keys at those values."""
    return {**dataclasses.asdict(ref_cfg), **PORT_ONLY}
