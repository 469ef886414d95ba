"""One run of one cell: the configuration's entry, then every metric the
cell reports read from what the run recorded, then the result's line."""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from typing import Any, Dict, Optional, Tuple

from pbcore import check, spec, trace

# top-level module names no run may hold: JAX, and the JAX package the
# port was made from (compared whole: the port, repro_torch, is another)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Ctx:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float
    control: bool = False


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def power_limit_w() -> Optional[float]:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run(root: str, workload: str, seed: int, seconds: float, traced: bool,
        t0: float, device: str = "cuda", control: bool = False,
        bench_file: str = "BENCHMARK.json", bench_dir: str = spec.HERE
        ) -> Tuple[Dict[str, Any], Any]:
    """(the result's line as a dict, the entry's record).  ``bench_dir``
    holds the cell's traffic and limits files (``spec.load_cell``)."""
    cell = spec.load_cell(root, workload, bench_file, bench_dir)
    ctx = Ctx(cell=cell, seed=seed, seconds=seconds, trace=traced,
              device=device, t0=t0, control=control)
    rec = spec.entry(cell.config["entry"]).run(ctx)
    metrics: Dict[str, Dict[str, Any]] = {}
    for m in cell.reported(traced):
        value = spec.reader(m.name)(rec)
        if value is None:
            if m.end_to_end:
                raise RuntimeError(f"end-to-end metric {m.name} read nothing")
            continue
        metrics[m.name] = {"value": float(value), "unit": m.unit}
    result: Dict[str, Any] = {
        "correct": check.passed(rec.checks),
        "attempted": int(rec.attempted),
        "failed": int(rec.failed),
        "metrics": metrics,
        "device": rec.device,
    }
    if traced and rec.trace is not None:
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in trace.device_ops(rec.trace)],
            "idle_gaps": [[n, s] for n, s in trace.idle_gaps(rec.trace)]}
    if device == "cuda":
        result["power_limit_w"] = power_limit_w()
    result["checks"] = rec.checks
    return result, rec
