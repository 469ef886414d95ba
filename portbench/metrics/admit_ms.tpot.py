"""Admission (``RequestScheduler._admit``: the B 1 prefill and the pages'
write): device ms of the gaps before the window's admitting steps, from
the previous step's end to this step's start, over the requests admitted
in them."""


def read(rec):
    gap_ms, admitted = rec.tl.admission_gaps()
    return gap_ms / admitted if admitted else None
