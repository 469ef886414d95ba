"""The window arithmetic of a served stream, frozen.

A run records two CUDA events around every decode step's launch, so step
``k`` started at ``start_ms[k]`` and ended at ``end_ms[k]`` on the device's
clock (milliseconds after an event recorded before the stream).  Each
request carries the step that admitted it (``admitted``) and its last step
(``finished``); in the closed loop every slot is refilled in the gap before
the step after its request retired, so:

* a request admitted at step ``a > 0`` was sent at ``end_ms[a - 1]``, the
  end of the step in which its predecessor in that slot retired;
* its first token (the prefill's) exists at ``start_ms[a]``, the end of
  the admission gap before its first step;
* each of its ``n`` steps yields one more token, the last (the argmax of
  the last step's logits) at ``end_ms[finished]``.

The window opens at the first step that starts ``ramp_ms`` or more after
the stream's first step and lasts ``seconds``; a step belongs to it when it
starts and ends inside.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Req:
    rid: int
    prompt_len: int
    n: int              # decode steps = tokens after the first
    admitted: int
    finished: int


class Timeline:
    def __init__(self, start_ms: Sequence[float], end_ms: Sequence[float],
                 reqs: Sequence[Req], ramp_ms: float, seconds: float):
        self.start = np.asarray(start_ms, dtype=np.float64)
        self.end = np.asarray(end_ms, dtype=np.float64)
        if self.start.shape != self.end.shape or not len(self.start):
            raise ValueError("a timeline needs a start and an end per step")
        self.reqs = list(reqs)
        self.seconds = float(seconds)
        K = len(self.start)
        self.active = np.zeros(K, dtype=np.int64)
        self.admitted = np.zeros(K, dtype=np.int64)
        d = np.zeros(K + 1, dtype=np.int64)
        for r in self.reqs:
            if r.finished - r.admitted + 1 != r.n:
                raise ValueError(f"request {r.rid} ran {r.finished - r.admitted + 1}"
                                 f" steps for {r.n} tokens")
            d[r.admitted] += 1
            d[r.finished + 1] -= 1
            self.admitted[r.admitted] += 1
        self.active = np.cumsum(d[:K])
        base = self.start[0]
        first = np.flatnonzero(self.start - base >= ramp_ms)
        if not len(first):
            raise ValueError(f"the stream ended within its {ramp_ms} ms ramp")
        self.first = int(first[0])
        self.ws = float(self.start[self.first])
        self.we = self.ws + 1e3 * self.seconds
        self.in_window = (self.start >= self.ws) & (self.end <= self.we)

    # -- the window ------------------------------------------------------

    def window_steps(self) -> np.ndarray:
        return np.flatnonzero(self.in_window)

    def last_admission_ms(self) -> float:
        """When the queue ran dry: the start of the last step that
        admitted a request."""
        return float(self.start[np.flatnonzero(self.admitted)[-1]])

    def queue_held(self) -> bool:
        """Whether requests still waited for a slot when the window closed."""
        return self.last_admission_ms() >= self.we

    def drain_s(self) -> float:
        """Device seconds from the window's close to the stream's end."""
        return (float(self.end[-1]) - self.we) / 1e3

    def tokens(self) -> int:
        """Tokens emitted by the steps of the window: one per request a
        step serves."""
        return int(self.active[self.in_window].sum())

    # -- per request -----------------------------------------------------

    def ttft_ms(self) -> List[float]:
        """First token minus send time, of every request sent in the
        window (the initial fill was sent before it)."""
        out = []
        for r in self.reqs:
            if r.admitted == 0:
                continue
            sent = self.end[r.admitted - 1]
            if self.ws <= sent < self.we:
                out.append(float(self.start[r.admitted] - sent))
        return out

    def tpot_ms(self) -> List[float]:
        """(last token - first token) / (tokens - 1) of every request
        whose first token falls in the window."""
        out = []
        for r in self.reqs:
            first = self.start[r.admitted]
            if self.ws <= first < self.we:
                out.append(float(self.end[r.finished] - first) / r.n)
        return out

    def admission_gaps(self, steps: np.ndarray = None) -> Tuple[float, int]:
        """(milliseconds of the gaps before the window's steps that admit,
        requests admitted in them)."""
        steps = self.window_steps() if steps is None else steps
        steps = steps[(steps > 0) & (self.admitted[steps] > 0)]
        gaps = self.start[steps] - self.end[steps - 1]
        return float(gaps.sum()), int(self.admitted[steps].sum())

    def decode_keys(self, lo: int, hi: int) -> Tuple[int, int]:
        """(rows served, keys attended) summed over steps ``lo..hi``
        (inclusive): at step ``k`` a request admitted at ``a`` attends to
        its prompt, the ``k - a`` tokens it has had and the new one."""
        rows = keys = 0
        for r in self.reqs:
            a, b = max(lo, r.admitted), min(hi, r.finished)
            if a > b:
                continue
            m = b - a + 1
            first = r.prompt_len + (a - r.admitted) + 1
            rows += m
            keys += m * first + m * (m - 1) // 2
        return rows, keys

    def window_range(self) -> Tuple[int, int]:
        """The first and last step of the window (they are contiguous)."""
        steps = self.window_steps()
        if not len(steps):
            raise ValueError(f"no step fits in the {self.seconds} s window")
        return int(steps[0]), int(steps[-1])

    def prompts_admitted(self, steps: np.ndarray) -> List[int]:
        """The prompt lengths prefilled in the gaps before ``steps``."""
        s = set(int(k) for k in steps)
        return [r.prompt_len for r in self.reqs if r.admitted in s]
