"""The profiler's raw events, reduced.

A traced run profiles a bounded slice of steps right after the window
with ``torch.profiler`` (CPU and CUDA activity) and reads the raw events
(``prof.profiler.kineto_results.events()``), never ``key_averages()``,
which builds a tree of every event first and takes tens of seconds at a
stream's size.  Device events are every kernel, copy and set the card ran
(a replayed CUDA graph's kernels appear one by one); host events are the
ops and spans of the thread that drove the slice.

* the traced window: from the first device event's start to the last
  one's end;
* busy: the union of the device events' intervals in it;
* device ops: device time summed by name;
* idle gaps: the gaps of that union, each named by the innermost host op
  running at its midpoint (gaps under ``SHORT_NS`` are grouped as the
  space between one kernel and the next).
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

SHORT_NS = 10_000   # gaps below 10 us: the space between back-to-back kernels


@dataclasses.dataclass
class TraceData:
    device: List[Tuple[int, int, str]]          # (start ns, end ns, name)
    host: List[Tuple[int, int, str]]            # the driving thread's ops

    @property
    def window_ns(self) -> Tuple[int, int]:
        return (min(s for s, _, _ in self.device),
                max(e for _, e, _ in self.device))


def collect(prof, slice_name: str) -> Optional[TraceData]:
    """Device events and the host events of the thread that ran the span
    ``slice_name``; None where the trace holds no device event."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, cpu = [], []
    thread = None
    for e in prof.profiler.kineto_results.events():
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        if e.device_type() == cuda:
            # a span's device-side twin (gpu_user_annotation) is no work
            if not e.is_user_annotation() and e.name() != slice_name:
                dev.append((start, end, e.name()))
        else:
            cpu.append((start, end, e.name(), e.start_thread_id()))
            if e.name() == slice_name:
                thread = e.start_thread_id()
    if not dev:
        return None
    host = [(s, t, n) for s, t, n, th in cpu if th == thread]
    return TraceData(device=sorted(dev), host=sorted(host))


def union(intervals: Sequence[Tuple[int, int, str]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e, _ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(td: TraceData) -> int:
    return sum(e - s for s, e in union(td.device))


def device_ops(td: TraceData, top: int = 10) -> List[Tuple[str, float]]:
    """The device operations that took most time: (name, seconds)."""
    acc: Dict[str, int] = defaultdict(int)
    for s, e, n in td.device:
        acc[n] += e - s
    rows = sorted(acc.items(), key=lambda kv: kv[1], reverse=True)[:top]
    return [(n, ns / 1e9) for n, ns in rows]


def kernel_ns(td: TraceData, needles: Sequence[str]) -> Tuple[int, int]:
    """(device ns, count) of the events whose name holds any of
    ``needles``."""
    total = count = 0
    for s, e, n in td.device:
        if any(k in n for k in needles):
            total += e - s
            count += 1
    return total, count


def _innermost(host: List[Tuple[int, int, str]], starts: List[int], t: int
               ) -> Optional[str]:
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 512), -1):
        s, e, n = host[j]
        if s <= t <= e:
            return n
    return None


def idle_gaps(td: TraceData, top: int = 10) -> List[Tuple[str, float]]:
    """The device's idle gaps, summed by what the host was doing: (name,
    seconds), longest first."""
    spans = union(td.device)
    starts = [s for s, _, _ in td.host]
    acc: Dict[str, int] = defaultdict(int)
    for (_, a), (b, _) in zip(spans[:-1], spans[1:]):
        gap = b - a
        if gap < SHORT_NS:
            acc["between kernels (gaps under 10 us)"] += gap
            continue
        name = _innermost(td.host, starts, (a + b) // 2)
        acc[f"host in {name}" if name else "host outside any op"] += gap
    rows = sorted(acc.items(), key=lambda kv: kv[1], reverse=True)[:top]
    return [(n, ns / 1e9) for n, ns in rows]
