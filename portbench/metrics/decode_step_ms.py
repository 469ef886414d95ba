"""The graphed decode step: device ms from the CUDA event before a step's
launch to the one after it, averaged over the window's steps."""


def read(rec):
    steps = rec.tl.window_steps()
    return float((rec.tl.end[steps] - rec.tl.start[steps]).mean())
