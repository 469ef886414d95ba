"""The routed experts' three products (gate, up and down over the
dispatch buffer) of the graphed decode step's moe layers: device ms a
step in the traced slice (``pbcore/moe_layer.py`` finds them); nothing
where the trace holds no decode moe layer."""

from pbcore import moe_layer
from pbcore.readers import slice_steps


def read(rec):
    if rec.trace is None:
        return None
    sections = moe_layer.decode_sections(rec.trace.device)
    if not sections:
        return None
    ns = sum(e - s for sec in sections for s, e, _ in sec["experts"])
    return ns / 1e6 / slice_steps(rec)
