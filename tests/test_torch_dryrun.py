"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, and the accelerator route against ``route_tpu``.

* **Against the reference.**  One subprocess runs the reference's
  ``run_cell`` on a ``(2, 4)`` ``("data", "model")`` mesh of 8 forced host
  devices for ``llama3.2-1b`` at ``train_4k`` and ``decode_32k``, and
  reports beside each cell its ``aux`` byte terms, its ``dot_general``
  FLOPs a device (a jaxpr walk that multiplies scan bodies by their
  length) and its collective bytes recounted with each collective's true
  group size: the reference's parser reads a group size only from the
  iota form ``replica_groups=[n,g]<=[N]`` and takes 2 for an explicit
  list such as ``{{0,1,2,3},{4,5,6,7}}``, which XLA prints for the decode
  cell's model-axis all-reduces.  The port's ``run_cell`` on the same mesh
  of ``meta`` devices must give the argument bytes, every ``aux`` byte
  count, ``model_flops`` and the product FLOPs a device exactly, and each
  kind of collective bytes within 10% of that recount.  XLA's CPU backend
  carries every 16-bit collective in fp32 (an all-reduce of bf16 becomes
  one of f32 with a ``clone_promoted`` reduction), so the port's
  collectives are priced at 4 bytes an element for this comparison; the
  report itself prices them at their dtype.  With the reference's
  ``TPU_V5E`` constants (its collective term over 3 links), the port's
  bottleneck is the reference's.
* **The sweep.**  ``decode_32k`` for every arch and ``train_4k`` for
  ``llama3.2-1b`` on the ``(16, 16)`` meta mesh give ``ok``; ``long_500k``
  gives exactly the reference's skips and ``ok`` elsewhere.  (The other
  archs' ``train_4k`` cells take 5-40 s each on this CPU, past the file's
  budget; ``python -m repro_torch.launch.dryrun --all`` runs them.)
  Nothing is allocated on any device: every tensor of a cell is ``meta``.
* **ZeRO.**  ``strategy="zero"`` gathers the weights instead of tensor
  parallelism, and holds fewer argument bytes a device.
* **The route.**  ``route_accelerator(..., constants=TPU_V5E)`` equals
  ``route_tpu`` for every arch x shape.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

pytest.importorskip("jax")

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.cost_model import TPU_V5E  # noqa: E402
from repro.launch.dryrun import LONG_CONTEXT_ARCHS as REF_LONG  # noqa: E402
from repro.serving.router import route_tpu  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.core.cost_model import AcceleratorCostConstants  # noqa: E402
from repro_torch.distributed.costing import ring_bytes  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.serving.router import route_accelerator  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, CELLS = "llama3.2-1b", ("train_4k", "decode_32k")
COLL_TOL = 0.10

REFERENCE = textwrap.dedent("""
    import json, os, re, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro.distributed import costing as C
    from repro.launch import dryrun as D
    from repro.launch.mesh import make_mesh

    def dots(jaxpr):
        total = 0.0
        for eqn in jaxpr.eqns:
            name = eqn.primitive.name
            if name == "dot_general":
                total += C._dot_flops(eqn)
            elif name == "scan":
                total += dots(eqn.params["jaxpr"].jaxpr) * eqn.params["length"]
            elif name == "cond":
                total += max((dots(b.jaxpr) for b in eqn.params["branches"]),
                             default=0.0)
            else:
                for sub in C._sub_jaxprs(eqn.params):
                    total += dots(sub)
        return total

    seen = {}
    build, line_bytes, coll = D.build_cell, C._line_collective_bytes, D.collective_bytes

    def build_cell(*a, **k):
        out = build(*a, **k)
        seen["aux"] = out[3]
        return out

    def traced_flops(fn, *args):
        jx = jax.make_jaxpr(fn)(*args)
        seen["dots"] = dots(jx.jaxpr)
        return C.jaxpr_flops(jx.jaxpr)

    def true_groups(line):
        m = re.search(r"replica_groups=\\{\\{([0-9,]+)\\}[^ ]*", line)
        if m:
            g = len(m.group(1).split(","))
            line = line.replace(m.group(0), f"replica_groups=[{8 // g},{g}]<=[8],")
        return line_bytes(line)

    def collective_bytes(hlo):
        C._line_collective_bytes = true_groups
        try:
            seen["true_groups"] = C.collective_bytes(hlo)[0]
        finally:
            C._line_collective_bytes = line_bytes
        return coll(hlo)

    D.build_cell, D.traced_flops, D.collective_bytes = (
        build_cell, traced_flops, collective_bytes)
    mesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    for shape in sys.argv[2:]:
        r = D.run_cell(sys.argv[1], shape, mesh=mesh, verbose=False)
        assert r.status == "ok", r.note
        out[shape] = dict(report=r.to_dict(), aux=seen["aux"],
                          dots_per_device=seen["dots"] / mesh.size,
                          true_groups=seen["true_groups"])
    print("REF " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REFERENCE, ARCH, *CELLS],
                         env=env, capture_output=True, text=True, cwd=ROOT,
                         timeout=600)
    lines = [l for l in res.stdout.splitlines() if l.startswith("REF ")]
    assert lines, res.stderr[-3000:]
    return json.loads(lines[-1][4:])


def _v5e():
    return AcceleratorCostConstants(
        peak_bf16_flops=TPU_V5E.peak_bf16_flops,
        hbm_bandwidth=TPU_V5E.hbm_bandwidth,
        link_bandwidth=3 * TPU_V5E.ici_link_bandwidth,
        hbm_bytes=TPU_V5E.hbm_bytes)


@pytest.mark.parametrize("shape", CELLS)
def test_cell_against_the_reference(reference, shape):
    ref = reference[shape]
    mesh = make_mesh((2, 4), ("data", "model"), ["meta"] * 8)
    before = torch.cuda.memory_allocated() if torch.cuda.is_available() else 0
    r = dryrun.run_cell(ARCH, shape, mesh=mesh, verbose=False,
                        constants=_v5e())
    assert r.status == "ok", r.note
    want = ref["report"]
    assert r.argument_bytes == want["argument_bytes"]
    assert r.aux == ref["aux"]
    assert r.model_flops == want["model_flops"]
    assert r.product_flops_per_device == ref["dots_per_device"]
    assert r.bottleneck == want["bottleneck"]
    # each kind of collective bytes, priced as XLA's CPU backend carries it
    colls = dryrun.build_cell(ARCH, shape, mesh).collectives
    widened = {}
    for c in colls:
        item = max(4, torch.empty((), dtype=c.dtype).element_size())
        n = 1
        for s in c.shape:
            n *= s
        widened[c.kind] = widened.get(c.kind, 0.0) + c.count * ring_bytes(
            c.kind, n * item, c.group)
    recount = ref["true_groups"]
    assert set(widened) == set(recount)
    for kind, b in recount.items():
        assert abs(widened[kind] / b - 1) <= COLL_TOL, (kind, widened[kind], b)
    assert set(r.collective_bytes) == set(recount)
    print(f"[dryrun] {ARCH} x {shape} on (2, 4): port {r.collective_bytes} "
          f"(fp32-priced {widened}); reference as reported "
          f"{want['collective_bytes']}, recounted {recount}")
    if torch.cuda.is_available():
        assert torch.cuda.memory_allocated() == before


def test_sweep_on_the_production_mesh():
    mesh = make_production_mesh()
    cells = [(a, "decode_32k") for a in list_archs()]
    cells += [(ARCH, "train_4k")]
    cells += [(a, "long_500k") for a in list_archs()]
    for arch, shape in cells:
        r = dryrun.run_cell(arch, shape, mesh=mesh, verbose=False)
        if shape == "long_500k" and arch not in REF_LONG:
            assert r.status == "skip", (arch, r.note)
        else:
            assert r.status == "ok", (arch, shape, r.note)
            assert r.mesh == "16x16" and r.memory_term_s > 0
            assert r.bottleneck in ("compute", "memory", "collective")
    assert dryrun.LONG_CONTEXT_ARCHS == REF_LONG


def test_zero_strategy_gathers_the_weights():
    mesh = make_production_mesh()
    tp = dryrun.run_cell(ARCH, "decode_32k", mesh=mesh, verbose=False)
    zero = dryrun.run_cell(ARCH, "decode_32k", mesh=mesh, verbose=False,
                           strategy="zero")
    assert zero.status == "ok" and zero.mesh == "16x16+zero", zero.note
    # every weight gathered once a use, no tensor-parallel partial sums
    assert "all-gather" in zero.collective_bytes
    assert zero.aux["param_bytes_dev"] == tp.aux["param_bytes_dev"]
    assert zero.argument_bytes < tp.argument_bytes
    with pytest.raises(ValueError, match="tp or zero"):
        dryrun.build_cell(ARCH, "decode_32k", mesh, strategy="ep")


def test_route_equals_route_tpu():
    for arch in list_archs():
        for name in SHAPES:
            want = route_tpu(ref_get_config(arch), REF_SHAPES[name])
            got = route_accelerator(get_config(arch), SHAPES[name],
                                    constants=TPU_V5E)
            assert (got.chips, got.reason) == (want.chips, want.reason), (arch, name)
    got = route_accelerator(get_config("internlm2-1.8b"), SHAPES["decode_32k"])
    assert got.chips >= 1


def test_cli_single_cell(tmp_path, capsys):
    out = tmp_path / "cell.json"
    assert dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k",
                        "--json", str(out)]) == 0
    cells = json.loads(out.read_text())
    assert [c["status"] for c in cells] == ["ok"]
    assert "1 ok / 0 skip / 0 error" in capsys.readouterr().out
