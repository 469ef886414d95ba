"""Seconds from the harness's first line to the measured stream's start
(host clock): imports, the card's start, weights, the scheduler and its
CUDA graph, the kernels' builds where the checkout has none, the warm-up."""


def read(rec):
    return rec.setup_s
