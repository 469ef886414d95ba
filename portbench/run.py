"""One run of one cell of the port's benchmark, on this machine's cards.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix
and its metrics are found by name from ``BENCHMARK.json`` (see
``pbcore/spec.py``).  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer ones with ``--trace 1``),
``device``, with ``--trace 1`` a ``breakdown``, ``power_limit_w`` (the
card's, by ``nvidia-smi``), and last ``checks``: each number compared with
the reference beside its limit, which the last lines of standard error
repeat.  Exits non-zero, and prints no result, without a
CUDA card (or with fewer than the cell asks for), when a file is missing,
or when the process holds JAX or the JAX package once the window has
closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _paths() -> None:
    """The harness's own modules, then the port (``src/repro_torch``, whose
    kernels nvcc builds into ``src/repro_torch/kernels/*/build/`` inside the
    checkout: only a checkout's first run builds them)."""
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    src = os.path.join(ROOT, "src")
    if src not in sys.path:
        sys.path.insert(1, src)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    from pbcore import runner, spec

    cell = spec.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, _ = runner.run(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), T0)
    bad = runner.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
