"""The port's cost extraction (``repro_torch.distributed.costing``) against
the JAX package's (``repro.distributed.costing``).

* the reference's ``TestFlopCounting`` cases with the same numbers: a dot
  exactly ``2·64·128·32``; a loop of 7 products; a checkpointed call plus a
  plain one, both counted (and the checkpoint's recomputation under
  autograd); a gradient counting its backward products;
* ``ring_bytes`` on the reference's HLO case: ``24·ar_one + ag_one``, the
  reference's ``collective_bytes`` of that HLO;
* ``analytic_hbm_bytes`` equal to the reference's on a grid;
* every family at its reduced config: the products of forward, prefill, a
  decode step and loss plus gradient equal the reference's ``dot_general``
  FLOPs, read from its jaxpr by a walk that multiplies scan bodies by
  their length.  The ssm and hybrid families' SSD scan computes its
  products in another form on each side (the port's chunked scan is the
  plain version of the CUDA kernel, with its own contractions): the SSD
  scan is replaced on both sides by the same product-free stand-in, and
  the rest is held exactly.  Each family's loss plus gradient is compared
  with its config's remat (on for all) and with remat off.  Remat off,
  every family is exact.  Remat on, the dense, vlm, encdec and ssm
  families are exact, and the port's recomputation of the moe and hybrid
  blocks runs products that the reference's jaxpr leaves out of its own
  (torch's checkpoint reruns a block up to the last tensor its backward
  reads); the difference is held exactly to the number measured at the
  reduced configs (``REMAT_EXTRA``);
* ``make_train_step(grad_shardings=...)`` bit for bit the same step
  without it.
"""

import dataclasses

import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.distributed import costing as ref_costing  # noqa: E402
from repro.models import mamba2 as ref_mamba2  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.distributed import costing  # noqa: E402
from repro_torch.distributed.sharding import P, param_pspecs, placements  # noqa: E402
from repro_torch.launch.mesh import MeshAxes, make_mesh  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402
from repro_torch.training.train_state import (make_train_step,  # noqa: E402
                                              value_and_grad)


def meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


# ---------------------------------------------------------------------------
# the reference's flop-counting cases
# ---------------------------------------------------------------------------


class TestFlopCounting:
    def test_dot_flops_exact(self):
        a, b = meta(64, 128), meta(128, 32)
        _, tr = costing.trace_step(lambda: a @ b)
        want = ref_costing.traced_flops(
            lambda x, y: x @ y, jax.ShapeDtypeStruct((64, 128), jnp.float32),
            jax.ShapeDtypeStruct((128, 32), jnp.float32))
        assert tr.flops == tr.product_flops == want == 2 * 64 * 128 * 32
        assert costing.traced_flops(lambda x, y: x @ y, a, b) == want

    def test_loop_counts_every_pass(self):
        def f(x):
            for _ in range(7):
                x = x @ x
            return x

        def g(x):
            return jax.lax.scan(lambda c, _: (c @ c, None), x, None, length=7)[0]

        want = ref_costing.traced_flops(
            g, jax.ShapeDtypeStruct((32, 32), jnp.float32))
        assert costing.traced_flops(f, meta(32, 32)) == want == 7 * 2 * 32 ** 3

    def test_checkpoint_and_plain_call_counted(self):
        def inner(x):
            # tanh's backward reads its output: a recomputation must rerun
            # the product
            return torch.tanh(torch.einsum("ij,jk->ik", x, x))

        def f(x):
            return torch.utils.checkpoint.checkpoint(
                inner, x, use_reentrant=False) + inner(x)

        x = meta(16, 16)
        _, tr = costing.trace_step(f, x)
        assert tr.product_flops == 2 * (2 * 16 ** 3)  # both calls counted
        # under autograd the checkpointed product runs again in backward
        xg = meta(16, 16, grad=True)

        def fg(x):
            return torch.autograd.grad(f(x).sum(), x)

        _, tr = costing.trace_step(fg, xg)
        # forward 2, recompute 1, and each product's two cotangent products
        assert tr.product_flops == (2 + 1 + 4) * 2 * 16 ** 3

    def test_grad_includes_backward(self):
        def loss(w, x):
            return torch.sum((x @ w) ** 2)

        w, x = meta(64, 64, grad=True), meta(8, 64)
        fwd = costing.traced_flops(loss, w, x)
        both = costing.traced_flops(
            lambda w, x: torch.autograd.grad(loss(w, x), w), w, x)
        assert both > 2 * fwd  # fwd + 2 backward matmuls
        _, tr = costing.trace_step(
            lambda: torch.autograd.grad(loss(w, x), w))
        # the forward product and the weight's cotangent product (x needs none)
        assert tr.product_flops == 2 * (2 * 8 * 64 * 64)

    def test_peak_bytes_follow_live_storage(self):
        def f(x):
            a = x * 2          # 4 KB live
            b = a * 3          # 8 KB
            del a
            return b * 4       # 8 KB again: a is gone

        _, tr = costing.trace_step(f, meta(1024))
        assert tr.peak_bytes == 2 * 4096


# ---------------------------------------------------------------------------
# collectives and the memory term
# ---------------------------------------------------------------------------


def test_ring_formulas_on_the_references_hlo():
    from test_dryrun import TestCollectiveParsing

    per_kind, total = ref_costing.collective_bytes(TestCollectiveParsing.HLO)
    ar_one = 2 * 128 * 256 * 4 * 15 / 16
    ag_one = 128 * 256 * 4 * 7 / 8
    size = 128 * 256 * 4
    assert costing.ring_bytes("all-reduce", size, 16) == ar_one
    assert costing.ring_bytes("all-gather", size, 8) == ag_one
    colls = [costing.Collective("all-reduce", (128, 256), torch.float32, 16,
                                24, "loop"),
             costing.Collective("all-gather", (128, 256), torch.float32, 8,
                                1, "gather")]
    got, got_total = costing.collective_bytes(colls)
    assert got == {"all-reduce": 24 * ar_one, "all-gather": ag_one}
    assert got == per_kind and got_total == total == 24 * ar_one + ag_one
    # the other kinds, one line of HLO each, through the reference's parser
    for kind in ("reduce-scatter", "all-to-all", "collective-permute"):
        line = (f"  %c = f32[128,256]{{1,0}} {kind}(%x), "
                f"replica_groups=[32,8]<=[256]")
        assert costing.ring_bytes(kind, size, 8) == \
            ref_costing._line_collective_bytes(line)
    assert costing.ring_bytes("all-reduce", size, 1) == 0.0


def test_analytic_hbm_bytes_grid():
    for kind in ("train", "prefill", "decode"):
        for p in (0.0, 1.5e9, 3e10):
            for o in (0.0, 7e9):
                for s in (0.0, 2.5e8):
                    for c in (0.0, 1.7e10):
                        for io in (64.0, 1e6):
                            kw = dict(param_bytes_dev=p, opt_bytes_dev=o,
                                      stash_bytes_dev=s, cache_bytes_dev=c,
                                      io_bytes_dev=io, kind=kind)
                            assert costing.analytic_hbm_bytes(**kw) == \
                                ref_costing.analytic_hbm_bytes(**kw)


# ---------------------------------------------------------------------------
# the families' products against the reference's dot_general FLOPs
# ---------------------------------------------------------------------------


def dot_flops(jaxpr) -> float:
    """The ``dot_general`` FLOPs of a jaxpr, scan bodies times their
    length, every other nested jaxpr once (the reference's walk, products
    only)."""
    total = 0.0
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "dot_general":
            total += ref_costing._dot_flops(eqn)
        elif prim == "scan":
            total += dot_flops(eqn.params["jaxpr"].jaxpr) * eqn.params["length"]
        elif prim == "cond":
            total += max((dot_flops(b.jaxpr) for b in eqn.params["branches"]),
                         default=0.0)
        else:
            for sub in ref_costing._sub_jaxprs(eqn.params):
                total += dot_flops(sub)
    return total


def ref_dots(fn, *args) -> float:
    return dot_flops(jax.make_jaxpr(fn)(*args).jaxpr)


def port_products(fn) -> float:
    return costing.trace_step(fn)[1].product_flops


# the same product-free stand-ins for the SSD scan on both sides (outputs
# of the scan's shapes that read every input elementwise)
def _ssd_stub(np_):
    def chunked(x, dt, A, Bm, Cm, chunk, init_state=None):
        y = (x * dt[..., None] * A[:, None]
             + (Bm * Cm).sum((-1, -2))[..., None, None])
        s = (x.sum(1)[..., None] * A[None, :, None, None]
             * Bm.sum((1, 2))[:, None, None, :])
        if init_state is not None:
            s = s + init_state
        return y, s

    def decode(x, dt, A, Bm, Cm, state):
        y = (x * dt[..., None] * A[:, None]
             + (Bm * Cm).sum((-1, -2))[..., None, None])
        return y, state * A[None, :, None, None] + x[:, 0, ..., None] * \
            Bm[:, 0].sum(1)[:, None, None, :]
    return chunked, decode


# products the port's recomputation adds at the reduced configs, in FLOPs
# (B 2, S 64): deepseek-moe-16b's three moe blocks, zamba2-7b's blocks
REMAT_EXTRA = {"deepseek-moe-16b": 6291456.0, "zamba2-7b": 58720256.0}
ARCHS = ("internlm2-1.8b", "deepseek-moe-16b", "mamba2-370m", "zamba2-7b",
         "seamless-m4t-medium", "internvl2-2b")
B, S = 2, 64


@pytest.fixture
def ssd_stubbed(monkeypatch):
    rc, rd = _ssd_stub(jnp)
    pc, pd = _ssd_stub(torch)
    monkeypatch.setattr(ref_mamba2, "ssd_chunked", rc)
    monkeypatch.setattr(ref_mamba2, "ssd_decode", rd)
    monkeypatch.setattr(mamba2, "ssd_chunked", pc)
    monkeypatch.setattr(mamba2, "ssd_decode", pd)


@pytest.mark.parametrize("arch", ARCHS)
def test_family_products_equal_the_references_dots(arch, ssd_stubbed):
    rcfg = ref_get_config(arch).reduced()
    pcfg = get_config(arch).reduced()
    assert rcfg.remat and pcfg.remat
    rm, pm = ref_registry.get_model(rcfg), registry.get_model(
        pcfg, attn_backend="dense-ref")
    rp = jax.eval_shape(rm.init, jax.random.key(0))
    pp = registry.abstract_params(pcfg)
    got, want = {}, {}
    train = ShapeConfig("t", S, B, "train")
    pre = ShapeConfig("p", S, B, "prefill")
    dec = ShapeConfig("d", S, B, "decode")

    rb, pb = ref_registry.input_specs(rcfg, train), registry.input_specs(pcfg, train)
    want["forward"] = ref_dots(rm.forward, rp, rb)
    got["forward"] = port_products(lambda: pm.forward(pp, pb))

    rb, pb = ref_registry.input_specs(rcfg, pre), registry.input_specs(pcfg, pre)
    want["prefill"] = ref_dots(lambda p, b: rm.prefill(p, b, S), rp, rb)
    got["prefill"] = port_products(
        torch.no_grad()(lambda: pm.prefill(pp, pb, S)))

    rb, pb = ref_registry.input_specs(rcfg, dec), registry.input_specs(pcfg, dec)
    rc, pc = ref_registry.cache_specs(rcfg, dec), registry.cache_specs(pcfg, dec)
    want["decode"] = ref_dots(rm.decode_step, rp, rb["token"], rc)
    got["decode"] = port_products(
        torch.no_grad()(lambda: pm.decode_step(pp, pb["token"], pc)))

    rb, pb = ref_registry.input_specs(rcfg, train), registry.input_specs(pcfg, train)
    pp.requires_grad_(True)
    for remat in (True, False):
        rc_ = dataclasses.replace(rcfg, remat=remat)
        pc_ = dataclasses.replace(pcfg, remat=remat)
        rm_ = ref_registry.get_model(rc_)
        pm_ = registry.get_model(pc_, attn_backend="dense-ref")
        key = f"loss+grad remat {remat}"
        want[key] = ref_dots(jax.value_and_grad(rm_.loss_fn), rp, rb)
        got[key] = port_products(
            lambda: value_and_grad(pm_.loss_fn, pp, pb, pm_.ref_leaves(pp)))
    got["loss+grad remat True"] -= REMAT_EXTRA.get(arch, 0.0)
    assert got == want


# ---------------------------------------------------------------------------
# grad_shardings places and never changes
# ---------------------------------------------------------------------------


def test_grad_shardings_step_is_bit_identical():
    cfg = get_config("internlm2-1.8b").reduced()
    api = registry.get_model(cfg, attn_backend="dense-ref")
    shape = ShapeConfig("t", 32, 2, "train")
    batch = registry.input_specs(cfg, shape, abstract=False, seed=3)
    mesh = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    runs = []
    for pinned in (False, True):
        params = api.init(torch.Generator().manual_seed(0))
        params.requires_grad_(True)
        tree = api.ref_leaves(params)
        opt = optimizer.get_optimizer(cfg)
        state = opt.init(tree)
        shard = (placements(mesh, param_pspecs(cfg, tree, MeshAxes(mesh)))
                 if pinned else None)
        for mb in (1, 2):
            step = make_train_step(api.loss_fn, opt, api.ref_leaves,
                                   microbatches=mb, grad_shardings=shard)
            params, state, metrics = step(params, state, batch)
        runs.append((params, state, metrics))
    (p0, s0, m0), (p1, s1, m1) = runs
    for (n, a), b in zip(p0.named_parameters(), p1.parameters()):
        assert torch.equal(a, b), n
    for key in ("m", "v"):
        for k, leaf in s0[key].items():
            assert torch.equal(leaf.stacked(), s1[key][k].stacked()), k
    assert int(s0["step"]) == int(s1["step"]) == 2
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    assert isinstance(shard, dict) and all(
        isinstance(pl.spec, P) for pl in shard.values())
