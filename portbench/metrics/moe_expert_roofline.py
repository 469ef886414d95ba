"""The routed experts' products' share (%) of their roofline in the traced
slice: the bytes they need (the weights of the experts each decode moe
layer hits and the assignments' tokens in and out, from the program's
routing counters; ``pbcore/moe_layer.py``) at the card's HBM bandwidth,
over their device time.  Nothing where the trace holds no decode moe
layer or the program keeps no routing counters."""

from pbcore import moe_layer


def read(rec):
    if rec.trace is None or rec.peaks is None:
        return None
    sections = moe_layer.decode_sections(rec.trace.device)
    counters = moe_layer.routing_counters()
    if not sections or counters is None:
        return None
    calls = counters["layer_calls"]
    per_layer = moe_layer.expert_bytes_per_layer(
        rec.model, counters["experts_hit"] / calls,
        counters["assignments"] / calls)
    ns = sum(e - s for sec in sections for s, e, _ in sec["experts"])
    seconds = per_layer * len(sections) / rec.peaks["hbm_bytes_per_s"]
    return 100.0 * seconds / (ns / 1e9)
