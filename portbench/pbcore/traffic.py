"""The one traffic generator: a mix is a file of parameters, this reads it.

A mix's file (``traffic/<name>.json``) gives:

* ``loop``: ``"closed"``, the only kind so far: ``clients`` callers, each
  sending its next request when its last one has finished;
* ``prompt`` and ``output``: the length distributions, ``{"dist":
  "lognormal", "median", "sigma", "min", "max"}`` in tokens (clipped);
* ``sizes``: how many (prompt, output) pairs one block of requests holds.
  The pairs are the two distributions at the quantiles ``(i + 0.5) /
  sizes``, the outputs paired with the prompts by a permutation drawn from
  ``pair_seed``.  The stream is blocks of these pairs, each block in an
  order drawn from ``pair_seed`` too, so every run, whatever its
  ``--seed``, serves the same sequence of sizes and does the same work in
  the same steps (in a closed loop the order decides how admissions
  cluster, which moved tokens/s by several percent from seed to seed);
  prompt tokens are uniform over the vocabulary, drawn from the run's
  seed;
* ``ramp_s``: device seconds served before the measured window opens, so
  that the clients' requests no longer start in step with each other;
* ``greedy``: every request decodes greedily (the comparison with the
  reference holds greedy tokens only).
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, List, Tuple

import numpy as np

_TAG_PERM, _TAG_TOKENS = 1, 2


def _seed_words(seed: int) -> List[int]:
    """Any whole number, as non-negative 32-bit words for SeedSequence."""
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32]


def lengths(dist: Dict[str, Any], n: int) -> np.ndarray:
    """``n`` lengths: ``dist`` at the quantiles (i + 0.5) / n, rounded and
    clipped to [min, max], ascending."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    nd = statistics.NormalDist()
    out = [dist["median"] * np.exp(dist["sigma"] * nd.inv_cdf((i + 0.5) / n))
           for i in range(n)]
    return np.clip(np.rint(out), dist["min"], dist["max"]).astype(np.int64)


class Mix:
    """The requests of one run: request ``i``'s size depends only on the
    mix and ``i``, its tokens on the seed too, so a longer stream extends a
    shorter one."""

    def __init__(self, traffic: Dict[str, Any], seed: int, vocab: int):
        if traffic.get("loop") != "closed":
            raise ValueError(f"unknown loop {traffic.get('loop')!r}")
        if not traffic.get("greedy", False):
            raise ValueError("only greedy mixes can be compared with the "
                             "reference")
        self.traffic = traffic
        self.seed = seed
        self.vocab = int(vocab)
        self.clients = int(traffic["clients"])
        n = int(traffic["sizes"])
        prompts = lengths(traffic["prompt"], n)
        outputs = lengths(traffic["output"], n)
        perm = np.random.default_rng(int(traffic["pair_seed"])).permutation(n)
        self.pairs: List[Tuple[int, int]] = [
            (int(p), int(o)) for p, o in zip(prompts, outputs[perm])]
        self._blocks: Dict[int, np.ndarray] = {}

    @property
    def max_request_len(self) -> int:
        """The longest request the mix can send: the clip bounds, so the
        capacity is the same for every seed."""
        return int(self.traffic["prompt"]["max"]) + int(self.traffic["output"]["max"])

    def size(self, i: int) -> Tuple[int, int]:
        """(prompt length, new tokens) of request ``i``."""
        n = len(self.pairs)
        b = i // n
        if b not in self._blocks:
            rng = np.random.default_rng(
                [int(self.traffic["pair_seed"]), _TAG_PERM, b])
            self._blocks[b] = rng.permutation(n)
        return self.pairs[int(self._blocks[b][i % n])]

    def prompt(self, i: int) -> np.ndarray:
        """Request ``i``'s prompt tokens, int32, uniform over the vocabulary."""
        p, _ = self.size(i)
        rng = np.random.default_rng(_seed_words(self.seed) + [_TAG_TOKENS, i])
        return rng.integers(0, self.vocab, size=p, dtype=np.int64).astype(np.int32)
