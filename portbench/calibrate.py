"""Readings for a cell's limits: the program's and the control's, on many
seeds, in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 3 ...

Each seed is a whole run of the cell (weights, scheduler, warm-up, the
stream at the cell's load and window, the check) in which the check also
judges the control: the reference computed with fp8 products in the
program's place (``pbcore/check.py``).  One line of JSON a seed on
standard output: the program's readings and whether they pass the cell's
limits, the control's and whether they do (the run's ``correct``).  The
benchmark's own runs never run the control.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window (default: BENCHMARK.json's run_seconds)")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench._paths()
    import torch

    from pbcore import check, runner

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    if args.seconds is None:
        with open(f"{bench.ROOT}/BENCHMARK.json") as f:
            args.seconds = float(json.load(f)["run_seconds"])
    for seed in args.seeds:
        t = time.perf_counter()
        result, rec = runner.run(bench.ROOT, args.workload, seed, args.seconds,
                                 False, t, control=True)
        limits = result["checks"]
        program = {**rec.extra["readings"], "unfinished": rec.extra["unfinished"]}
        ok = check.passed(check.verdict(program, {k: c["limit"] for k, c
                                                  in limits.items()}))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": program, "program_correct": ok,
                          "control": rec.extra["control"],
                          "control_correct": result["correct"],
                          "metrics": {k: v["value"] for k, v
                                      in result["metrics"].items()},
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
