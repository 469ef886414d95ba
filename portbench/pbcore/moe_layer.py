"""The moe layer of the graphed decode step in a device trace, and the
bytes its routed experts' products need.

Every replay of the decode step's CUDA graph launches one fixed sequence
of kernels.  In it each moe layer follows its layer's decode attention
(``decode_attention_kernel``) and opens with the router's product, the
step's only fp32 product (``ROUTER``); the three products over the
dispatch buffer (the routed experts' gate, up and down) are the next three
matrix products (``GEMM``), the shared experts' three come next.  The
layer's section is read from the router's product up to the shared
experts' first product: its routing and dispatch before the experts'
products, its combine after them.  The three routed products are known by
their kernels' names (``EXPERTS``): where a layer's first three products
after the router are not those, in that order, or the fourth is one of
them, the routed experts run another way (a grouped product, a fused
gate and up) and no section is read from the trace at all, so that the
readers read nothing rather than a wrong layer.  A prefill's moe layers (an admission's
graph, between two steps) follow no decode attention and are left out.
The kernel names are fixed from the first trace (NVIDIA H100, PyTorch
2.11): the router's product is CUTLASS's
``cutlass_80_simt_sgemm_64x64_8x5_nn_align1`` (with a cuBLASLt
``splitKreduce_kernel``, counted with the routing), the experts' products
``nvjet_tss_384x32_...`` (gate, up) and ``nvjet_tss_512x32_...`` (down),
the shared experts' ``nvjet_tss_64x16_...``; each of the 27 layers of a
step is found, and no prefill's.

The bytes of the routed experts' products in one layer are those the
work needs, not what the dispatch buffer holds: the weights of each
expert hit (``w_gate``, ``w_up`` and ``w_down``, in the parameters'
dtype) and the assignments' tokens in (the activations' dtype) and out
(fp32), from the program's routing counters.  Those are the run's totals
over every decode step the scheduler ran (its warm-up steps, the ramp,
the window, the traced slice and the drain), so the bytes are the run's
mean a layer call, applied to the traced slice's time.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

from pbcore import counts

DECODE_ATTN = "decode_attention_kernel"
ROUTER = ("sgemm",)                         # fp32 x fp32 products
GEMM = ("gemm", "nvjet", "cutlass")         # any matrix product
# the routed experts' gate, up and down products over the dispatch buffer
EXPERTS = ("nvjet_tss_384x32_", "nvjet_tss_384x32_", "nvjet_tss_512x32_")


def _is(name: str, needles) -> bool:
    return any(k in name for k in needles)


def decode_sections(device: List[Tuple[int, int, str]]
                    ) -> List[Dict[str, List[Tuple[int, int, str]]]]:
    """Each decode moe layer's events in the trace, ordered by start:
    ``{"route": [...], "experts": [...], "combine": [...]}``; none at all
    where one layer's routed products are not the three ``EXPERTS``."""
    out = []
    pending = False
    i, n = 0, len(device)
    while i < n:
        name = device[i][2]
        if DECODE_ATTN in name:
            pending = True
        elif pending and _is(name, ROUTER):
            pending = False
            j, gemms = i + 1, []
            while j < n and len(gemms) < 4:
                if DECODE_ATTN in device[j][2]:
                    break
                if _is(device[j][2], GEMM) and not _is(device[j][2], ROUTER):
                    gemms.append(j)
                j += 1
            if len(gemms) < 4:
                return []
            routed = [device[g][2] for g in gemms[:3]]
            if (not all(want in got for want, got in zip(EXPERTS, routed))
                    or _is(device[gemms[3]][2], EXPERTS)):
                return []
            g1, g3, s1 = gemms[0], gemms[2], gemms[3]
            out.append({"route": device[i:g1],
                        "experts": [device[g] for g in gemms[:3]],
                        "combine": device[g3 + 1:s1]})
            i = s1
            continue
        i += 1
    return out


def routing_counters() -> Optional[Dict[str, float]]:
    """The program's decode routing counters (``repro_torch.core.spans``),
    or None where the program keeps none."""
    mod = sys.modules.get("repro_torch.core.spans")
    read = getattr(mod, "counters", None)
    if read is None:
        return None
    c = read().get("moe.decode")
    if not c or not c.get("layer_calls"):
        return None
    return c


def expert_bytes_per_layer(m: Dict, experts_hit: float, assignments: float
                           ) -> float:
    """Bytes one moe layer's routed-expert products need."""
    w = counts.dtype_bytes(m["param_dtype"])
    d, f = m["d_model"], m["moe_d_ff"]
    return (experts_hit * 3 * d * f * w
            + assignments * d * (w + counts.dtype_bytes("float32")))
