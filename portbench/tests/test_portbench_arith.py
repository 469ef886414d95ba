"""The window, percentile, TTFT and TPOT arithmetic on synthetic records,
and the FLOP, byte and parameter counts against hand-worked shapes."""

import json
import os

import numpy as np
import pytest

from pbcore import counts, stats, weights
from pbcore.traffic import Mix, lengths
from pbcore.window import Req, Timeline

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)["model"]


def test_percentile_is_numpy_linear():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 333):
        x = rng.lognormal(size=n)
        for q in (0, 50, 90, 95, 100):
            assert stats.percentile(x, q) == pytest.approx(np.percentile(x, q))
    assert stats.percentile([], 95) is None


def _timeline(ramp_ms=0.0, seconds=0.05):
    # six steps of 10 ms; gaps: 4 ms before step 0 (the fill), 0 before
    # step 1, 6 before step 2 (one admission), 0, 12 before step 4 (two
    # admissions), 0
    start = [4, 14, 30, 40, 62, 72]
    end = [14, 24, 40, 50, 72, 82]
    reqs = [Req(0, 100, 2, 0, 1),    # retires after step 1
            Req(1, 50, 4, 0, 3),     # retires after step 3
            Req(2, 70, 2, 2, 3),     # admitted before step 2, retires after 3
            Req(3, 10, 2, 4, 5),
            Req(4, 20, 2, 4, 5)]
    return Timeline(start, end, reqs, ramp_ms, seconds)


def test_timeline_window_and_tokens():
    tl = _timeline(seconds=0.05)
    # window from step 0's start (4 ms) for 50 ms: steps 0-3 end inside
    assert (tl.ws, tl.we) == (4.0, 54.0)
    assert list(tl.window_steps()) == [0, 1, 2, 3]
    assert list(tl.active) == [2, 2, 2, 2, 2, 2]
    assert tl.tokens() == 8
    assert tl.window_range() == (0, 3)
    assert tl.queue_held()              # the last admission (62) is past 54
    tl2 = _timeline(ramp_ms=20.0, seconds=0.05)
    assert tl2.ws == 30.0 and list(tl2.window_steps()) == [2, 3, 4]  # 5 ends at 82


def test_ttft_tpot_and_admission_gaps():
    tl = _timeline(seconds=0.1)
    # sent at the end of the step before admission: req 2 at 24 (first
    # token 30), reqs 3 and 4 at 50 (first token 62)
    assert sorted(tl.ttft_ms()) == [6.0, 12.0, 12.0]
    # (end of the last step - first token) / n
    want = {0: (24 - 4) / 2, 1: (50 - 4) / 4, 2: (50 - 30) / 2,
            3: (82 - 62) / 2, 4: (82 - 62) / 2}
    assert sorted(tl.tpot_ms()) == sorted(want.values())
    assert tl.admission_gaps() == (6.0 + 12.0, 3)
    # keys: request r at step k attends to prompt + (k - admitted) + 1
    rows, keys = tl.decode_keys(2, 3)
    assert rows == 4
    assert keys == (51 + 2) + (51 + 3) + (71 + 72)
    assert tl.prompts_admitted(np.array([2, 4])) == [70, 10, 20]


def test_timeline_rejects_a_wrong_step_count():
    with pytest.raises(ValueError):
        Timeline([0], [1], [Req(0, 5, 3, 0, 0)], 0.0, 1.0)


def test_counts_by_hand_dense():
    m = {"family": "dense", "n_layers": 2, "d_model": 8, "n_heads": 2,
         "n_kv_heads": 1, "d_head": 4, "d_ff": 16, "padded_vocab": 32,
         "param_dtype": "bfloat16", "kv_cache_dtype": "bfloat16"}
    attn = 8 * 8 + 2 * 8 * 4 + 8 * 8          # q, k, v, o
    body = 2 * (attn + 3 * 8 * 16)
    assert counts.body_params_per_token(m) == body
    assert counts.head_params(m) == 8 * 32
    # a prefill of 3: 3 tokens through the body, one head row, 1+2+3 keys
    per_key = 4 * 2 * 4 * 2
    assert counts.prefill_flops(m, 3) == 2 * 3 * body + 2 * 256 + per_key * 6
    assert counts.decode_flops(m, 2, 9) == 2 * 2 * (body + 256) + per_key * 9
    # 2 rows over 9 keys: K and V of 1 head x 4 dims in bf16, q and out of
    # 2 heads x 4 dims in bf16, a length each
    assert counts.decode_attn_bytes(m, 2, 9) == 2 * 9 * 4 * 2 + 2 * (2 * 8 * 2 + 4)


@pytest.mark.parametrize("name,params", [("internlm2-1.8b", 1889634304)])
def test_schema_holds_the_published_parameters(name, params):
    """The seed's weights are the model's whole parameter count (the port's
    modules on the card held exactly these; each run logs the count)."""
    assert weights.param_count(_model(name)) == params


def test_traffic_sizes_are_one_sequence_for_every_seed():
    with open(os.path.join(BENCH, "traffic", "lmsys-chat-128.json")) as f:
        t = json.load(f)
    a, b = Mix(t, 1, 92544), Mix(t, 2**31 + 5, 92544)
    n = t["sizes"]
    # each block is the one multiset, in an order of its own
    blk_0 = [a.size(i) for i in range(n)]
    blk_1 = [a.size(i) for i in range(n, 2 * n)]
    assert sorted(blk_0) == sorted(blk_1) == sorted(a.pairs)
    assert blk_0 != blk_1
    # every seed serves the same sizes; the seed draws the tokens
    assert [b.size(i) for i in range(3 * n)] == [a.size(i) for i in range(3 * n)]
    assert np.array_equal(a.prompt(3), Mix(t, 1, 92544).prompt(3))
    assert not np.array_equal(a.prompt(3), b.prompt(3))
    # the clipped means are the source's (LMSYS-Chat-1M: 69.5 and 214.5)
    assert abs(lengths(t["prompt"], n).mean() - 69.5) < 0.1
    assert abs(lengths(t["output"], n).mean() - 214.5) < 0.1
    assert a.max_request_len == 512 + 1024
