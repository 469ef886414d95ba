"""The check on the CPU, at the tiny cells: a sound run is correct, and a
run with the timed path broken underneath is not, once for each fault a
served cell can have.  A cell on one card has no exchange between cards to
leave out; the four-card fault is for a cell that has one.  The control
(the reference with fp8 products in the program's place) fails too."""

import pytest
import torch

from _tiny import CELLS, run


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, rec = run(cell)
    assert result["correct"], result["checks"]
    assert rec.extra["readings"]["positions"] > 100
    assert result["failed"] == 0 and result["attempted"] > 0
    # the stream ran the steps its plan gave, each request admitted where
    # the plan put it
    assert rec.extra["plan_held"], rec.extra


def _wrap_decode(monkeypatch, change):
    """Wrap the dense family's ``decode_step`` so that ``change(call,
    logits)`` edits the logits each step returns."""
    from repro_torch.models import transformer as module

    orig = module.decode_step
    calls = []

    def broken(*args, **kwargs):
        logits, cache = orig(*args, **kwargs)
        calls.append(1)
        return change(len(calls), logits.clone()), cache

    monkeypatch.setattr(module, "decode_step", broken)


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged_fails(cell, monkeypatch):
    """The step's new K and V never reach the pool: later steps attend to
    what the pages held before."""
    from repro_torch.serving import kv_pool

    monkeypatch.setattr(kv_pool.KVBlockPool, "scatter_token",
                        lambda self, buffers, *a, **k: buffers)
    result, _ = run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out_fails(cell, monkeypatch):
    """The step computes only the first half of its slots; the rest get
    zero logits."""
    def half(call, logits):
        logits[logits.shape[0] // 2:] = 0.0
        return logits

    _wrap_decode(monkeypatch, half)
    result, _ = run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_altered_token_fails(cell, monkeypatch):
    """Every seventh step puts another token first in every slot."""
    def alter(call, logits):
        if call % 7 == 3:
            best = logits.argmax(dim=-1, keepdim=True)
            other = (best + 1) % logits.shape[-1]
            logits.scatter_(-1, other, (logits.max() + 1.0).expand(other.shape))
        return logits

    _wrap_decode(monkeypatch, alter)
    result, _ = run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    """The reference with fp8 products in the program's place: its tokens,
    judged as the served ones are, make the run not correct, while the
    same run's served tokens pass."""
    from pbcore import check

    result, rec = run(cell, control=True)
    assert result["correct"] is False, result["checks"]
    limits = {k: c["limit"] for k, c in result["checks"].items()}
    program = {**rec.extra["readings"], "unfinished": rec.extra["unfinished"]}
    assert check.passed(check.verdict(program, limits)), program
    assert result["checks"]["widest_gap"]["value"] == rec.extra["control"]["widest_gap"]
    assert torch.isfinite(torch.tensor(rec.extra["control"]["widest_gap"]))
