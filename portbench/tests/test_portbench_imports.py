"""No process the benchmark starts holds JAX or the JAX package: after a
whole tiny run's imports, no module in ``sys.modules`` has the top-level
name (before the first dot, compared whole) ``jax``, ``jaxlib``, ``flax``
or ``repro``; the port, ``repro_torch``, passes."""

import os
import subprocess
import sys

from pbcore import runner

TESTS = os.path.dirname(os.path.abspath(__file__))


def test_forbidden_names_compare_whole():
    mods = ["repro_torch", "repro_torch.models", "reprox", "repro",
            "repro.core", "jax.numpy", "jaxlib", "flax.linen", "jaxtyping"]
    assert runner.forbidden_modules(mods) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "import conftest, _tiny\n"
            "result, _ = _tiny.run('tiny-dense-chat')\n"
            "from pbcore import runner\n"
            "assert result['correct']\n"
            "print(runner.forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, TESTS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
