"""FLOP and byte counts of the work a served stream needs, frozen.

They count what these inputs need of the model that the configuration's
file states, whatever implements it: two FLOPs a multiply-add of every
product over the parameters a token uses, attention over the keys each
token actually attends to (causal in a prefill: position ``p`` attends to
``p`` keys), and the unembedding once a prefill (a prefill yields the last
position's logits) and once a decode row.  They do not count what a kernel
happens to read or compute beyond that: padding, a dispatch buffer's
empty slots, the gather of whole-capacity caches, vacant slots.

What depends on the model's family, the parameters of the products a
token runs through, comes from ``families/<family>.py``
(``body_params_per_token``); the rest holds for every family with
attention in each of its ``n_layers`` layers.
"""

from __future__ import annotations

from typing import Any, Dict

from pbcore import spec

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def dtype_bytes(name: str) -> int:
    return _DTYPE_BYTES[name]


def _attn_params(m: Dict[str, Any]) -> int:
    d, H, KV, Dh = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_head"]
    return d * H * Dh + 2 * d * KV * Dh + H * Dh * d


def body_params_per_token(m: Dict[str, Any]) -> int:
    """Parameters of the products a token runs through, the unembedding
    left out: the family's count."""
    return spec.family(m["family"]).body_params_per_token(m)


def head_params(m: Dict[str, Any]) -> int:
    return m["d_model"] * m["padded_vocab"]


def attn_flops_per_key(m: Dict[str, Any]) -> int:
    """FLOPs of one query against one key over every layer: q.k and p.v,
    each H x Dh multiply-adds."""
    return 4 * m["n_heads"] * m["d_head"] * m["n_layers"]


def prefill_flops(m: Dict[str, Any], prompt_len: int) -> int:
    P = int(prompt_len)
    return (2 * P * body_params_per_token(m) + 2 * head_params(m)
            + attn_flops_per_key(m) * P * (P + 1) // 2)


def decode_flops(m: Dict[str, Any], rows: int, keys: int) -> int:
    """``rows`` decode tokens attending to ``keys`` keys in all."""
    return (2 * rows * (body_params_per_token(m) + head_params(m))
            + attn_flops_per_key(m) * keys)


def decode_attn_bytes(m: Dict[str, Any], rows: int, keys: int) -> int:
    """Bytes one layer's decode attention needs over ``rows`` rows that
    attend to ``keys`` keys in all: K and V up to each row's length in the
    cache's dtype, each row's query read and output written in the
    activations' dtype, and its length (int32)."""
    kv = dtype_bytes(m["kv_cache_dtype"])
    act = dtype_bytes(m["param_dtype"])
    KV, H, Dh = m["n_kv_heads"], m["n_heads"], m["d_head"]
    return 2 * keys * KV * Dh * kv + rows * (2 * H * Dh * act + 4)
