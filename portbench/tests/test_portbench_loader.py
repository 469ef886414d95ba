"""Every cell of BENCHMARK.json finds its files by name, the file keeps to
the benchmark format, and a configuration, a mix, a cell and a metric can
be added as new files plus entries, with no edit to a file that is there."""

import filecmp
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from pbcore import spec

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_file_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    metrics = b["end_to_end"] + b["per_layer"]
    names = [x["name"] for x in b["configs"] + b["workloads"]] + [
        x["name"] for x in metrics]
    assert len(set(x["name"] for x in metrics)) == len(metrics)
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {
            "name", "unit", "better", "source", "layer", "moves", "workloads"}
    for w in b["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_cell_finds_its_files(cell):
    c = spec.load_cell(ROOT, cell)
    assert c.config["name"] == c.config_name
    spec.entry(c.config["entry"])
    spec.reference(c.config["reference"])
    assert c.limits["limits"] and c.limits["check_requests"] >= 1
    e2e = [m for m in c.metrics if m.end_to_end]
    assert "setup_s" in {m.name for m in e2e} and len(e2e) >= 2
    assert any(not m.end_to_end for m in c.metrics)
    for m in c.metrics:
        assert callable(spec.reader(m.name))
        if not m.end_to_end:   # the metric it moves is reported here too
            assert m.moves in {x.name for x in e2e}


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A throwaway configuration, mix, cell and metric added to a copy of
    the benchmark load by name; no file that was there changed."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    copy = tmp_path / "portbench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    with open(copy / "configs" / "internlm2-1.8b.json") as f:
        conf = json.load(f)
    conf["name"] = "extra-model"
    (copy / "configs" / "extra-model.json").write_text(json.dumps(conf))
    with open(copy / "traffic" / "lmsys-chat-128.json") as f:
        mix = json.load(f)
    mix["clients"] = 4
    (copy / "traffic" / "extra-mix.json").write_text(json.dumps(mix))
    (copy / "cells" / "extra-cell.json").write_text(json.dumps(
        {"check_requests": 2, "limits": {"widest_gap": 0.2}}))
    (copy / "metrics" / "extra_metric.py").write_text(
        "def read(rec):\n    return 42.0\n")
    with open(tmp_path / "BENCHMARK.json") as f:
        b = json.load(f)
    b["configs"].append({"name": "extra-model", "source": "x",
                         "file": "portbench/configs/extra-model.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "extra-cell", "config": "extra-model",
                           "traffic": "extra-mix", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "extra_metric", "unit": "ms",
                           "better": "lower", "source": "program_span",
                           "layer": "x", "moves": "output_tokens_per_s",
                           "workloads": ["extra-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from pbcore import spec\n"
        "c = spec.load_cell(sys.argv[2], 'extra-cell', bench_dir=sys.argv[1])\n"
        "assert c.traffic['clients'] == 4 and c.config['name'] == 'extra-model'\n"
        "names = [m.name for m in c.reported(True)]\n"
        "assert 'extra_metric' in names, names\n"
        "assert spec.reader('extra_metric', bench_dir=sys.argv[1])(None) == 42.0\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code, str(copy), str(tmp_path)],
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "ok", out.stderr
    cmp = filecmp.dircmp(BENCH, copy, ignore=["__pycache__"])
    assert not cmp.diff_files
    for sub in ("configs", "traffic", "cells", "metrics"):
        assert not filecmp.dircmp(os.path.join(BENCH, sub), copy / sub).diff_files
