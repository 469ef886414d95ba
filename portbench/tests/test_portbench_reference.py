"""The plain references against the port at a tiny size on the CPU, fp32:
the same weights (the seed's), the same tokens, logits within 1e-4.  The
test may import both; the references import neither the port nor JAX."""

import json
import os

import pytest
import torch

from pbcore import weights
from reference import dense

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _model(name):
    with open(os.path.join(DATA, "configs", name + ".json")) as f:
        return json.load(f)["model"]


@pytest.mark.parametrize("name,ref", [("tiny-dense", dense)])
def test_reference_matches_the_port(name, ref):
    from entries.stream import _module, port_config
    from repro_torch.models import transformer

    m = _model(name)
    cfg = port_config(m)
    module = _module(cfg, m, "cpu")
    weights.fill(module, m, seed=2**33 + 3)
    w = weights.Weights(m, 2**33 + 3, "cpu")
    g = torch.Generator().manual_seed(0)
    seqs = [torch.randint(0, m["vocab_size"], (n,), generator=g)
            for n in (9, 17, 5)]
    for s in seqs:
        want = transformer.forward(module, s[None], cfg)[0]
        got = ref.logits(w, m, [s], torch.arange(len(s)), [len(s)])
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # laid end to end, each sequence is still its own
    rows = torch.arange(sum(len(s) for s in seqs))
    joint = ref.logits(w, m, seqs, rows, [len(s) for s in seqs])
    alone = torch.cat([ref.logits(w, m, [s], torch.arange(len(s)), [len(s)])
                       for s in seqs])
    torch.testing.assert_close(joint, alone, rtol=1e-5, atol=1e-5)


def test_reference_imports_no_program():
    import sys

    import reference.common  # noqa: F401

    for mod in (dense, sys.modules["reference.common"]):
        with open(mod.__file__) as f:
            src = f.read()
        for word in ("import repro", "from repro", "import jax", "from jax"):
            assert word not in src, (mod.__name__, word)
