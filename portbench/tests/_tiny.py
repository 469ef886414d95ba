"""Tiny cells run on the CPU as the CLI runs a cell on the card: the same
entry, readers and check, at toy widths in fp32 (``data/``).  The CPU's
step and prefill times swing run to run far more than the card's, so the
stream is sized three times past its window here."""

import os
import time

from entries import stream
from pbcore import runner

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CELLS = ("tiny-dense-chat",)


def run(cell: str, seed: int = 7, seconds: float = 1.5, control: bool = False):
    """(the result's line as a dict, the entry's record)."""
    margin = stream.SIZE_MARGIN
    stream.SIZE_MARGIN = 3.0
    try:
        return runner.run(DATA, cell, seed, seconds, False, time.perf_counter(),
                          device="cpu", control=control, bench_dir=DATA)
    finally:
        stream.SIZE_MARGIN = margin
