"""The port's examples (``examples/torch_*.py``) and its training launcher
(``python -m repro_torch.launch.train``), each run once on the CPU at its
smallest arguments (``--device cpu``): each must finish and return 0, and
its own checks (outputs against the dense oracle, the sharded fleet bit
for bit ``torch-bsr``'s, the BSR layer op against the CSR layer, the loss
falling) must hold.  Their default, ``--device cuda``, raises without a
card."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from repro_torch.launch import train as train_launcher

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name,args", [
    ("torch_quickstart", []),
    ("torch_serverless_sparse_dnn", []),
    ("torch_cost_explorer", []),
    ("torch_train_lm", ["--steps", "8", "--batch", "4", "--seq", "16"]),
    ("torch_serve_lm", []),
])
def test_example_runs_on_the_cpu(name, args, capsys):
    assert _example(name).main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out


def test_examples_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        _example("torch_quickstart").main([])


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "history.json"
    assert train_launcher.main([
        "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "16",
        "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "2",
        "--microbatches", "2", "--json", str(out)]) == 0
    history = json.loads(out.read_text())
    assert history["step"] == [0, 1, 2]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_00000002", "step_00000003"]
    assert "on cpu: steps=3" in capsys.readouterr().out
