"""On the card (skips elsewhere): each cell of BENCHMARK.json at its own
size and window, one seed, with the control run beside the program: the
program's readings pass the cell's limits, and the run, judged on the
control's tokens in the program's place, comes out not correct.
``portbench/calibrate.py`` gives the same readings for many seeds."""

import json
import os
import time

import pytest

from pbcore import check, runner

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_control_fails_and_program_passes_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, rec = runner.run(ROOT, cell, 2**31 + 17, _bench()["run_seconds"],
                             False, time.perf_counter(), control=True)
    limits = {k: c["limit"] for k, c in result["checks"].items()}
    program = {**rec.extra["readings"], "unfinished": rec.extra["unfinished"]}
    assert check.passed(check.verdict(program, limits)), program
    assert result["correct"] is False, result["checks"]
