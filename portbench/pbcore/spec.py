"""The benchmark's files, found by name.

``BENCHMARK.json`` at the root of the checkout lists the configurations,
the cells and the metrics.  Everything that belongs to one of them sits in
a file of its own under ``portbench/``, named after it:

* a configuration: ``configs/<config>.json`` (the ``file`` its entry
  names), with its ``entry`` (``entries/<entry>.py``, the path a run
  drives), its ``reference`` (``reference/<reference>.py``, the plain
  model) and its ``model.family`` (``families/<family>.py``: the weight
  schema's blocks, ``block_kinds(m)``, and the parameters a token runs
  through, ``body_params_per_token(m)``; the program's module for the
  family comes from the port's own registry);
* a traffic mix: ``traffic/<traffic>.json``, parameters that the one
  generator (``pbcore/traffic.py``) reads;
* a cell: ``cells/<workload>.json``, the limits of its comparison;
* a metric: ``metrics/<name>.py``, a reader with ``read(rec)``.

A later change adds a cell, a configuration, a mix or a metric by adding
files and entries; none of these needs an edit to a file that is there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    end_to_end: bool
    workloads: Optional[List[str]]
    moves: Optional[str] = None

    def in_cell(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict[str, Any]          # the configuration's file, parsed
    config_name: str
    traffic: Dict[str, Any]         # the mix's file, parsed
    traffic_name: str
    chips: int
    limits: Dict[str, Any]          # cells/<name>.json
    metrics: List[Metric]           # every metric this cell reports

    def reported(self, trace: bool) -> List[Metric]:
        """The metrics a run prints: the end-to-end ones with ``--trace
        0``, the per-layer ones with ``--trace 1``."""
        return [m for m in self.metrics if m.end_to_end != bool(trace)]


def _read_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _under(root: str, rel: str) -> str:
    path = os.path.normpath(os.path.join(root, rel))
    if not path.startswith(os.path.normpath(root) + os.sep):
        raise ValueError(f"{rel!r} leads out of {root}")
    return path


def load_cell(root: str, name: str, bench_file: str = "BENCHMARK.json",
              bench_dir: str = HERE) -> Cell:
    """The cell ``name`` of ``root/bench_file`` with every file it names
    read; raises where a file is missing or a name is unknown.
    ``bench_dir`` holds the cell's data files (traffic and limits); its
    code (entry, reference, family) is imported from the ``portbench/``
    first on ``sys.path``, so a copy of the benchmark goes there."""
    bench = _read_json(os.path.join(root, bench_file))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    config = _read_json(_under(root, conf["file"]))
    if config.get("name") != conf["name"]:
        raise ValueError(f"{conf['file']} names {config.get('name')!r}, "
                         f"not {conf['name']!r}")
    fam = config["model"]["family"]
    path = family_file(fam)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{conf['file']}: no file for family "
                                f"{fam!r} at {path}")
    traffic = _read_json(os.path.join(bench_dir, "traffic",
                                      w["traffic"] + ".json"))
    limits = _read_json(os.path.join(bench_dir, "cells", name + ".json"))
    metrics = []
    for e2e, key in ((True, "end_to_end"), (False, "per_layer")):
        for m in bench[key]:
            metric = Metric(name=m["name"], unit=m["unit"], end_to_end=e2e,
                            workloads=m.get("workloads"), moves=m.get("moves"))
            if metric.in_cell(name):
                metrics.append(metric)
    return Cell(name=name, config=config, config_name=conf["name"],
                traffic=traffic, traffic_name=w["traffic"],
                chips=int(w["chips"]), limits=limits, metrics=metrics)


def reader(name: str, bench_dir: str = HERE) -> Callable[[Any], Optional[float]]:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod_name = "portbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def entry(name: str):
    """``entries/<name>.py``: the module with ``run(ctx)``, the path a
    configuration's runs drive."""
    return importlib.import_module(f"entries.{name}")


def reference(name: str):
    """``reference/<name>.py``: a configuration's plain model."""
    return importlib.import_module(f"reference.{name}")


def family_file(name: str) -> str:
    """Where ``families/<name>.py`` lies: in the ``families`` package on
    the import path, the one ``family`` imports from."""
    families = importlib.import_module("families")
    return os.path.join(os.path.dirname(families.__file__), name + ".py")


def family(name: str):
    """``families/<name>.py``: a model family's ``block_kinds(m)`` and
    ``body_params_per_token(m)``."""
    return importlib.import_module(f"families.{name}")
