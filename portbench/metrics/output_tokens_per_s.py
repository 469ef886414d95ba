"""Tokens emitted by the steps that end in the window, over the window's
seconds (the device's clock)."""


def read(rec):
    return rec.tl.tokens() / rec.tl.seconds
