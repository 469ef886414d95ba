"""The continuous-batching stream: ``RequestScheduler.run`` of the port.

Set-up draws the configuration's weights from the seed into the port's
parameter module, builds the engine and the scheduler as
``ServingEngine.generate_stream`` does (the engine's model and params, its
``cache_layout(max_request_len)``, the slot capacity padded by it), with
``max_request_len`` the mix's longest prompt plus its longest output, so
the capacity, and the captured step, are the same for every seed.  Short
warm-up streams through that scheduler (the shortest and longest prompts,
then one request at each prompt length the mix sends, the shorter half
and the longer half each timed) touch the cell's shapes and time a step
and a prefill.

The measured stream: every request arrives at step 0 and there are as many
slots as clients, so FIFO admission refills each freed slot before the
next step, a closed loop of ``clients`` callers.  Which step admits each
request follows from the sizes alone, so the closed loop played on the
host with the warm-up's times (``_plan``) gives the step ``H`` by which
the window (and a traced run's slice) has closed with a margin; the stream
holds the requests admitted before ``H``, each cut to end by ``H``, so the
run drains within a few seconds of the window (a run whose queue runs dry
inside the window fails).  ``around_step`` records a CUDA event before and
after each step's launch, which times every step and every admission gap
without a host sync.  A traced run profiles a slice of steps right after
the window (``_Slice``).  After the stream, the peak memory is read, the
program's state freed, and a sample of the finished requests compared with
the plain reference (``pbcore/check.py``); a control run judges the
control's tokens there in the program's place.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pbcore import check, spec, trace, weights
from pbcore.traffic import Mix
from pbcore.window import Req, Timeline

SLICE = "portbench.trace_slice"
SLICE_S = 1.5           # device seconds a traced run profiles
WARMUP_NEW = 2          # tokens of each warm-up request
SLICE_GAP_S = 0.2       # device seconds from the window's close to the slice
SIZE_MARGIN = 1.20      # the simulated stream outlasts its horizon by this much


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


class _Clock:
    """Marks on the device's stream (CUDA events) or, on the CPU, where
    every op has finished when it returns, the host's clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


@dataclasses.dataclass
class Record:
    """What a stream run leaves for the metrics' readers."""
    model: Dict[str, Any]
    tl: Timeline
    setup_s: float
    trace: Optional[trace.TraceData]
    slice_steps: Tuple[int, int]          # [first, last) profiled steps
    peaks: Optional[Dict[str, float]]
    device: Dict[str, Any]
    checks: Dict[str, Dict[str, float]]
    attempted: int
    failed: int
    extra: Dict[str, Any]


def port_config(m: Dict[str, Any]):
    """The port's ``ModelConfig`` with the configuration file's values."""
    from repro_torch.configs.base import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{k: v for k, v in m.items() if k in fields})
    if cfg.padded_vocab() != m["padded_vocab"]:
        raise ValueError(f"the port pads the vocabulary to "
                         f"{cfg.padded_vocab()}, the file says "
                         f"{m['padded_vocab']}")
    return cfg


def _module(cfg, m: Dict[str, Any], device):
    """The port's parameter module of ``cfg.family``, the class its
    registry builds, uninitialized, in the file's dtype."""
    from repro_torch.models import registry

    module_class = type(registry.abstract_params(cfg))
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[m["param_dtype"]]
    return module_class(cfg, dtype=dtype, device=device)


def _serve(sched, requests, clock: _Clock, hook=None):
    """Run one stream; returns (results, step start ms, step end ms), both
    from a mark made before it.  ``hook(k, when, marks, base)`` is called
    before and after step ``k``'s launch."""
    marks: List[Tuple[Any, Any]] = []
    clock.sync()
    base = clock.mark()

    def around(launch):
        k = len(marks)
        if hook is not None:
            hook(k, "before", marks, base)
        a = clock.mark()
        launch()
        b = clock.mark()
        marks.append((a, b))
        if hook is not None:
            hook(k, "after", marks, base)

    results = sched.run(requests, around_step=around)
    clock.sync()
    start = [clock.ms(base, a) for a, _ in marks]
    end = [clock.ms(base, b) for _, b in marks]
    return results, start, end


class _Slice:
    """The traced slice: ``steps`` steps from the first launched once the
    card has finished a step that ends ``SLICE_GAP_S`` past the window's
    close.  Finished steps are read from their CUDA events without waiting
    (``Event.query``), so the window holds neither the profiler's start
    nor its stop, which wait for the card; the queue is still full then."""

    def __init__(self, ramp_ms: float, seconds: float, steps: int):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.ramp_ms, self.seconds, self.steps = ramp_ms, seconds, steps
        self.seen = 0                       # steps known to have finished
        self.s0 = self.we = None
        self.k0 = self.k1 = None
        self.span = None

    def _past_window(self, marks, base) -> bool:
        while self.seen < len(marks) and marks[self.seen][1].query():
            a, b = marks[self.seen]
            self.seen += 1
            start = base.elapsed_time(a)
            if self.s0 is None:
                self.s0 = start
            if self.we is None and start - self.s0 >= self.ramp_ms:
                self.we = start + 1e3 * self.seconds
            if (self.we is not None and base.elapsed_time(b)
                    >= self.we + 1e3 * SLICE_GAP_S):
                return True
        return False

    def __call__(self, k, when, marks, base) -> None:
        if when == "before" and self.k0 is None and self._past_window(marks, base):
            torch.cuda.synchronize()
            self.prof.start()
            self.span = torch.autograd.profiler.record_function(SLICE)
            self.span.__enter__()
            self.k0, self.k1 = k, k + self.steps
        elif when == "after" and self.k1 is not None and k == self.k1 - 1:
            torch.cuda.synchronize()
            self.span.__exit__(None, None, None)
            self.prof.stop()


def _plan(mix: Mix, slots: int, step_ms: float, prefill_ms, horizon_ms: float
          ) -> Tuple[List[int], int, List[float]]:
    """The closed loop played on the host with the warm-up's times: (the
    step that admits each request, in rid order, up to the horizon; the
    first step that would start ``horizon_ms`` or more after the first
    step; each earlier step's start ms).  The steps are exact: FIFO
    admission fills every free slot before a step, and a request of ``o``
    tokens holds its slot ``o`` steps; only the times are estimates."""
    free_at = [0] * slots
    admit: List[int] = []
    t, k, starts = 0.0, 0, []
    while True:
        for s in range(slots):
            if free_at[s] == k:
                p, o = mix.size(len(admit))
                t += prefill_ms(p)
                admit.append(k)
                free_at[s] = k + o
        if starts and t - starts[0] >= horizon_ms:
            return admit, k, starts
        starts.append(t)
        t += step_ms
        k += 1


def run(ctx) -> Record:
    cell = ctx.cell
    m = cell.config["model"]
    dev = torch.device(ctx.device)
    clock = _Clock(dev)
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import Request, RequestScheduler

    cfg = port_config(m)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    module = _module(cfg, m, dev)
    n_params = weights.fill(module, m, ctx.seed)
    clock.sync()
    log(f"weights: {n_params} params drawn in {time.perf_counter() - t:.3f} s")
    engine = ServingEngine(cfg, params=module, device=dev)
    mix = Mix(cell.traffic, ctx.seed, m["vocab_size"])
    slots = mix.clients
    layout = engine.cache_layout(mix.max_request_len)
    capacity = layout.padded_len(mix.max_request_len)
    t = time.perf_counter()
    sched = RequestScheduler(engine.model, engine.params, num_slots=slots,
                             slot_capacity=capacity, layout=layout, device=dev)
    clock.sync()
    log(f"scheduler: {slots} slots, capacity {capacity}, pages of "
        f"{layout.block_k}, built in {time.perf_counter() - t:.3f} s")

    # warm-up: the shortest and the longest prompt (first calls), then one
    # request at each prompt length the mix sends (every prefill shape and
    # the captured step), the shorter half of the lengths in one stream and
    # the longer half in another, each timed: a prefill's time is taken as
    # linear in its length through the two
    prompts = sorted({p for p, _ in mix.pairs})
    halves = [h for h in (prompts[:len(prompts) // 2],
                          prompts[len(prompts) // 2:]) if h]
    rng = np.random.default_rng([0x3A, int(ctx.seed) % (1 << 32)])
    step_ms, fill = [], []
    for i, lens in enumerate([[prompts[0], prompts[-1]]] + halves):
        reqs = [Request(rid=j, prompt=rng.integers(0, m["vocab_size"], p)
                        .astype(np.int32), max_new_tokens=WARMUP_NEW)
                for j, p in enumerate(lens)]
        _, start, end = _serve(sched, reqs, clock)
        if i:
            fill.append((float(np.mean(lens)), start[0] / len(lens)))
            step_ms += [b - a for a, b in zip(start, end)]
    (p_lo, t_lo), (p_hi, t_hi) = fill[0], fill[-1]

    def prefill_ms(p: int) -> float:
        if p_hi == p_lo:
            return t_hi
        return t_lo + (t_hi - t_lo) * (p - p_lo) / (p_hi - p_lo)

    # The stream: the requests admitted before step H, by which the closed
    # loop, played with the warm-up's fastest step and its prefills, has
    # run 20% past the window (and a traced run's slice); each is cut to
    # end by H, so that the stream ends there.
    ramp_ms = 1e3 * float(cell.traffic.get("ramp_s", 0.0))
    end_ms = ramp_ms + 1e3 * ctx.seconds
    if ctx.trace:
        end_ms += 1e3 * (SLICE_GAP_S + SLICE_S)
    admit, horizon, sim_starts = _plan(mix, slots, min(step_ms), prefill_ms,
                                       SIZE_MARGIN * end_ms)
    requests = [Request(rid=i, prompt=mix.prompt(i),
                        max_new_tokens=min(mix.size(i)[1], horizon - a))
                for i, a in enumerate(admit) if a < horizon]
    n_requests = len(requests)
    cut = sum(1 for q in requests if q.max_new_tokens < mix.size(q.rid)[1])
    log(f"warm-up: step {min(step_ms):.3f} ms, prefill {t_lo:.3f} ms at "
        f"{p_lo:.1f} tokens, {t_hi:.3f} ms at {p_hi:.1f}; stream of {n_requests} "
        f"requests over {horizon} steps, {cut} cut to end by the last")

    # the traced slice: as many steps as the simulation runs in SLICE_S
    tracer = None
    if ctx.trace and dev.type == "cuda":
        per_ms = (len(sim_starts) - 1) / max(sim_starts[-1] - sim_starts[0], 1.0)
        tracer = _Slice(ramp_ms, ctx.seconds, max(1, int(1e3 * SLICE_S * per_ms)))

    clock.sync()
    setup_s = time.perf_counter() - ctx.t0
    results, start, end = _serve(sched, requests, clock, tracer)
    k0 = k1 = 0
    prof = None
    if tracer is not None:
        if tracer.k1 is None or tracer.k1 > len(start):
            raise RuntimeError(f"the stream of {len(start)} steps ended before "
                               f"the traced slice did")
        k0, k1, prof = tracer.k0, tracer.k1, tracer.prof
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    done = {r.rid: r for r in results}
    plan_held = (len(start) == horizon
                 and all(r.admitted_step == admit[r.rid] for r in results))
    failed = sum(1 for q in requests
                 if q.rid not in done
                 or len(done[q.rid].tokens) != q.max_new_tokens)
    reqs = [Req(rid=r.rid, prompt_len=r.prompt_len, n=len(r.tokens),
                admitted=r.admitted_step, finished=r.finished_step)
            for r in results]
    tl = Timeline(start, end, reqs, ramp_ms, ctx.seconds)
    if not tl.queue_held():
        raise RuntimeError(
            f"the queue ran dry {tl.we - tl.last_admission_ms():.1f} ms "
            f"before the window closed: the stream of {n_requests} requests "
            f"was sized too short")
    if prof is not None and tl.last_admission_ms() < end[k1 - 1]:
        log("the queue ran dry inside the traced slice")
    served = [check.Served(rid=r.rid, prompt=requests[r.rid].prompt,
                           tokens=np.asarray(r.tokens, np.int32),
                           next_token=int(np.argmax(r.final_logits)))
              for r in results]
    td = trace.collect(prof, SLICE) if prof is not None else None
    w0, w1 = tl.window_range()
    gap_ms, n_adm = tl.admission_gaps()
    log(f"stream: plan {(sim_starts[-1] - sim_starts[0]) / 1e3:.3f} s from "
        f"the first step to step {horizon}, ran "
        f"{(end[-1] - start[0]) / 1e3:.3f} s; window: step "
        f"{np.mean(np.subtract(end, start)[w0:w1 + 1]):.3f} ms, "
        f"{gap_ms / max(n_adm, 1):.3f} ms an admission, {n_adm} admissions")
    q_ms = 250.0 * ctx.seconds
    quarters = [tl.active[(tl.start >= tl.ws + i * q_ms)
                          & (tl.end <= tl.ws + (i + 1) * q_ms)].sum() / q_ms * 1e3
                for i in range(4)]
    log(f"stream: tokens/s in the window's quarters "
        f"{[round(float(x), 1) for x in quarters]}")
    log(f"stream: {len(start)} steps, window steps {tl.window_range()}, "
        f"queue held {(tl.last_admission_ms() - tl.we) / 1e3:.3f} s past the "
        f"window, drain {tl.drain_s():.3f} s, {len(results)} requests, "
        f"{len(tl.ttft_ms())} sent and {len(tl.tpot_ms())} started in the "
        f"window, traced steps [{k0}, {k1})")

    # the program's state goes before the reference runs
    del sched, engine, module, results, prof, tracer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    w = weights.Weights(m, ctx.seed, dev)
    smp = check.sample(served, ctx.seed, int(cell.limits["check_requests"]))
    readings, control = check.compare(spec.reference(cell.config["reference"]),
                                      w, m, smp, dev, control=ctx.control)
    del w
    judged = control if ctx.control else readings
    checks = check.verdict({**judged, "unfinished": failed},
                           cell.limits["limits"])
    log(f"reference: {len(smp)} requests in {time.perf_counter() - t:.3f} "
        f"s; program {readings}" + (f"; control {control}" if ctx.control
                                    else ""))

    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    if td is not None:
        lo, hi = td.window_ns
        device["busy_s"] = trace.busy_ns(td) / 1e9
        device["window_s"] = (hi - lo) / 1e9
    from pbcore import peaks as P
    return Record(model=m, tl=tl, setup_s=setup_s, trace=td,
                  slice_steps=(k0, k1), peaks=P.peaks_for(device["kind"]),
                  device=device, checks=checks, attempted=len(requests),
                  failed=failed,
                  extra={"readings": readings, "control": control,
                         "unfinished": failed, "n_requests": n_requests,
                         "steps": len(start), "horizon": horizon,
                         "plan_held": plan_held})
