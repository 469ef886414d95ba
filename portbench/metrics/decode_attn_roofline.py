"""The decode kernel's share (%) of its roofline in the traced slice: the
bytes its inputs need (K and V up to each row's length, the queries and
outputs; ``pbcore/counts.py``) at the card's HBM bandwidth, over the
device time of its launches (``decode_attention_kernel``) in the trace.
Where the trace holds fewer launches than layers x steps, the bytes are
those of the launches it holds (every launch of a step moves the same)."""

from pbcore import counts, trace
from pbcore.readers import slice_steps

KERNEL = "decode_attention_kernel"


def read(rec):
    if rec.trace is None or rec.peaks is None:
        return None
    ns, launches = trace.kernel_ns(rec.trace, [KERNEL])
    if not launches:
        return None
    k0, k1 = rec.slice_steps
    rows, keys = rec.tl.decode_keys(k0, k1 - 1)
    per_launch = counts.decode_attn_bytes(rec.model, rows, keys) / (
        slice_steps(rec))
    seconds = per_launch * launches / rec.peaks["hbm_bytes_per_s"]
    return 100.0 * seconds / (ns / 1e9)
