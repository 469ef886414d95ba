
from pbcore import counts
from pbcore.weights import Kind


def _attn(m, prefix, n):
    d, H, KV, Dh = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_head"]
    dt = m["param_dtype"]
    return [Kind(prefix, "ln_attn", n, (d,), dt, "ones"),
            Kind(prefix, "attn.wq", n, (d, H, Dh), dt, "normal", d),
            Kind(prefix, "attn.wk", n, (d, KV, Dh), dt, "normal", d),
            Kind(prefix, "attn.wv", n, (d, KV, Dh), dt, "normal", d),
            Kind(prefix, "attn.wo", n, (H, Dh, d), dt, "normal", H * Dh),
            Kind(prefix, "ln_mlp", n, (d,), dt, "ones")]


def _mlp(m, prefix, name, n, f):
    d, dt = m["d_model"], m["param_dtype"]
    return [Kind(prefix, name + ".wi_gate", n, (d, f), dt, "normal", d),
            Kind(prefix, name + ".wi_up", n, (d, f), dt, "normal", d),
            Kind(prefix, name + ".wo", n, (f, d), dt, "normal", f)]


def block_kinds(m):
    fd, n = m["first_dense_layers"], m["n_layers"] - m["first_dense_layers"]
    d, E, f, dt = m["d_model"], m["n_experts"], m["moe_d_ff"], m["param_dtype"]
    kinds = []
    if fd:
        kinds += _attn(m, "dense_blocks", fd)
        kinds += _mlp(m, "dense_blocks", "mlp", fd, m["d_ff"])
    kinds += _attn(m, "moe_blocks", n)
    kinds += [Kind("moe_blocks", "moe.router", n, (d, E), "float32", "normal", d),
              Kind("moe_blocks", "moe.w_gate", n, (E, d, f), dt, "normal", d),
              Kind("moe_blocks", "moe.w_up", n, (E, d, f), dt, "normal", d),
              Kind("moe_blocks", "moe.w_down", n, (E, f, d), dt, "normal", f)]
    kinds += _mlp(m, "moe_blocks", "moe.shared", n, f * m["n_shared_experts"])
    return kinds


def body_params_per_token(m):
    fd, n = m["first_dense_layers"], m["n_layers"] - m["first_dense_layers"]
    d, f = m["d_model"], m["moe_d_ff"]
    active = m["experts_per_token"] + m["n_shared_experts"]
    return (m["n_layers"] * counts._attn_params(m) + fd * 3 * d * m["d_ff"]
            + n * (d * m["n_experts"] + 3 * d * f * active))
