"""The whole model's share (%) of the card's bf16 peak: the FLOPs of
every token the window processed (its decode steps' rows at their actual
lengths, the prompts prefilled in its admission gaps; ``pbcore/counts.py``)
over the window's seconds times the peak."""

from pbcore import counts


def read(rec):
    if rec.peaks is None:
        return None
    lo, hi = rec.tl.window_range()
    rows, keys = rec.tl.decode_keys(lo, hi)
    steps = rec.tl.window_steps()
    flops = counts.decode_flops(rec.model, rows, keys) + sum(
        counts.prefill_flops(rec.model, p)
        for p in rec.tl.prompts_admitted(steps[steps > 0]))
    return 100.0 * flops / (rec.tl.seconds * rec.peaks["bf16_flops"])
