"""Continuous batching of seamless-m4t-medium (encdec: frames at admission, the cross-attention KV and ``src_length`` slot-resident; the reference's prefill compiled with XLA's excess precision off, ``_xla_strict``) at its ``reduced()`` size, against the
JAX package's scheduler on the CPU, through ``dense-ref`` and ``torch-splitk``: a request in a mixed
stream (three arrival orders, and a two-wave page-reuse stream) gives the
same tokens and final logits, bit for bit, as itself served alone through
a scheduler of the same width and capacity; the tokens of the port's
``generate`` at B = 1 (logits within 1e-4); and the reference's
``RequestScheduler``'s on the same fp32-cast params (logits within 1e-4).
The setup and the contracts are ``tests/_torch_cb_common.py``'s.
"""

import pytest

pytest.importorskip("jax")

from _torch_cb_common import (  # noqa: E402
    BACKENDS,
    DifferentialParity,
    case_ids,
    make_diff_case,
)

CASES = [(fam, be) for fam in ('encdec',) for be in BACKENDS[fam]]


@pytest.fixture(scope="module", params=CASES, ids=case_ids(CASES))
def diff_case(request):
    return make_diff_case(*request.param)


class TestDifferentialParity(DifferentialParity):
    """Stream ≡ solo bit for bit; ≈ ``generate`` and the reference."""
