"""The dense decoder (internlm2-1.8b): ``n_layers`` blocks, each RMS-normed
attention (GQA) and a gated MLP, as the port's ``Transformer`` holds them
(``blocks.<i>.attn.wq``, ...)."""

from __future__ import annotations

from typing import Any, Dict, List

from pbcore import counts
from pbcore.weights import Kind


def block_kinds(m: Dict[str, Any]) -> List[Kind]:
    prefix, n = "blocks", m["n_layers"]
    d, H, KV, Dh = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_head"]
    dt = m["param_dtype"]
    out = [
        Kind(prefix, "ln_attn", n, (d,), dt, "ones"),
        Kind(prefix, "attn.wq", n, (d, H, Dh), dt, "normal", d),
        Kind(prefix, "attn.wk", n, (d, KV, Dh), dt, "normal", d),
        Kind(prefix, "attn.wv", n, (d, KV, Dh), dt, "normal", d),
        Kind(prefix, "attn.wo", n, (H, Dh, d), dt, "normal", H * Dh),
        Kind(prefix, "ln_mlp", n, (d,), dt, "ones"),
    ]
    f = m["d_ff"]
    return out + [Kind(prefix, "mlp.wi_gate", n, (d, f), dt, "normal", d),
                  Kind(prefix, "mlp.wi_up", n, (d, f), dt, "normal", d),
                  Kind(prefix, "mlp.wo", n, (f, d), dt, "normal", f)]


def body_params_per_token(m: Dict[str, Any]) -> int:
    d, L = m["d_model"], m["n_layers"]
    attn = counts._attn_params(m)
    return L * (attn + 3 * d * m["d_ff"])
