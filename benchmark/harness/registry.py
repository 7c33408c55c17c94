"""Everything a cell is made of, found by name under the benchmark's folder.

* a cell: its entry in ``BENCHMARK.json``'s ``workloads``, and its traffic
  file ``benchmark/workloads/<cell>.json`` (the driver's name and its
  parameters);
* a configuration: its entry in ``configs`` and the file that entry names;
* a driver: ``benchmark/drivers/<name>.py``, with ``run(run)``;
* a model family and a plain reference: ``benchmark/families/<name>.py``
  and ``benchmark/reference/<name>.py``, named by a configuration's
  ``family`` and ``reference`` (``harness/family.py``);
* a metric: ``benchmark/metrics/<name>.py``, with ``read(run)``, which gives
  a number or None when the run has nothing for it to read.

A cell, a configuration, a driver, a family, a reference or a metric is added by adding its files
and its entries; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

FOLDER = "benchmark"


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(root: str, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return {**json.load(f), "name": name}
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def mix(root: str, name: str) -> dict:
    with open(os.path.join(root, FOLDER, "workloads", name + ".json")) as f:
        return json.load(f)


def module(root: str, kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` of ``root``, imported once."""
    path = os.path.join(root, FOLDER, kind, name + ".py")
    key = f"_bench_{kind}_{abs(hash(os.path.abspath(path)))}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list:
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if applies(m, cell_name)]
