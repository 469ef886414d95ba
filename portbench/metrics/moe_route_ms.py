"""Everything else of the graphed decode step's moe layers: the router's
product, the softmax and the top-k sort, the capacity tables, the gathers
of the dispatch, and the weighted combine in expert order (the shared
experts left out): device ms a step in the traced slice
(``pbcore/moe_layer.py``); nothing where the trace holds no decode moe
layer."""

from pbcore import moe_layer
from pbcore.readers import slice_steps


def read(rec):
    if rec.trace is None:
        return None
    sections = moe_layer.decode_sections(rec.trace.device)
    if not sections:
        return None
    ns = sum(e - s for sec in sections for part in ("route", "combine")
             for s, e, _ in sec[part])
    return ns / 1e6 / slice_steps(rec)
