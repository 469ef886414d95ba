"""The comparison that decides ``correct``, frozen.

Once the window has closed and the program's state is freed, a sample of
the requests the timed stream finished (drawn from the seed, with the
longest in it) runs through the configuration's plain reference: each
prompt with the tokens the stream served, teacher-forced, in fp32.  At
every position that yielded a served token (the prefill's, one per decode
step, the last the argmax of the last step's logits) the reference's best
logit minus its logit of the served token is a gap: 0 where the stream
chose what the reference would, small where the two disagree on a near
tie.  The widest gap over the sample is held to the cell's limit.

The control puts the reference, computed with fp8 products, in the
program's place: at the same positions its tokens are those the fp8
reference puts first, judged as the served ones are (``judge``), and a
control run's ``correct`` comes from them (``verdict``, ``passed``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_TAG_SAMPLE = 3


@dataclasses.dataclass
class Served:
    rid: int
    prompt: np.ndarray          # int32 [P]
    tokens: np.ndarray          # int32 [n]: the prefill's token, then one a step
    next_token: int             # argmax of the last step's logits

    @property
    def served(self) -> np.ndarray:
        """Every token the request yielded, the last step's included."""
        return np.append(self.tokens, self.next_token).astype(np.int64)


def sample(done: List[Served], seed: int, k: int) -> List[Served]:
    """``k`` of the finished requests: the longest (prompt and tokens;
    the lowest rid among equals) and ``k - 1`` drawn from the seed."""
    if not done:
        return []
    order = sorted(done, key=lambda r: (-(len(r.prompt) + len(r.tokens)), r.rid))
    rest = order[1:]
    s = int(seed) % (1 << 64)
    rng = np.random.default_rng([s & 0xFFFFFFFF, s >> 32, _TAG_SAMPLE])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [order[0]] + [rest[int(i)] for i in sorted(pick)]


def _layout(reqs: List[Served], device):
    seqs, rows, served, prompt_lens = [], [], [], []
    offset = 0
    for r in reqs:
        seq = np.concatenate([r.prompt, r.tokens]).astype(np.int64)
        seqs.append(torch.as_tensor(seq, device=device))
        P, n = len(r.prompt), len(r.tokens)
        rows.append(torch.arange(offset + P - 1, offset + P + n, device=device))
        served.append(torch.as_tensor(r.served, device=device))
        prompt_lens.append(P)
        offset += len(seq)
    return seqs, torch.cat(rows), torch.cat(served), prompt_lens


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The reference's best logit minus its logit of each token."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(1, tokens[:, None])[:, 0]


def judge(ref_logits: torch.Tensor, tokens: torch.Tensor) -> Dict[str, float]:
    """The readings of ``tokens`` against the reference's logits at their
    positions: the widest gap, the mean gap, the positions and how many
    are not the reference's best."""
    g = gaps(ref_logits, tokens)
    return {"widest_gap": float(g.max()), "mean_gap": float(g.mean()),
            "positions": int(len(g)), "served_not_best": int((g > 0).sum())}


def compare(ref_module, weights, m: Dict, reqs: List[Served], device,
            control: bool = False
            ) -> Tuple[Dict[str, float], Optional[Dict[str, float]]]:
    """(the served tokens' readings, with ``control`` the readings of the
    tokens the fp8 reference puts first at the same positions, else
    None)."""
    seqs, rows, served, prompt_lens = _layout(reqs, device)
    ref = ref_module.logits(weights, m, seqs, rows, prompt_lens)
    ctl = None
    if control:
        fp8 = ref_module.logits(weights, m, seqs, rows, prompt_lens,
                                quant="fp8")
        ctl = judge(ref, fp8.argmax(dim=-1))
    return judge(ref, served), ctl


def verdict(readings: Dict[str, float], limits: Dict[str, float]
            ) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit (``value <= limit`` passes)."""
    return {name: {"value": readings[name], "limit": float(lim)}
            for name, lim in limits.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
