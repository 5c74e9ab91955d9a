"""Finds the benchmark's parts by the names that ``BENCHMARK.json`` gives.

Every cell of ``BENCHMARK.json``'s ``workloads`` has a file of its own,
``l3dbench/workloads/<cell>.json``, with its entry, the pipeline's
``Config`` keyword arguments, its sampling and trace sizes and the limits of
its checks; every configuration the file that its ``file`` names; every
per-layer metric a module ``l3dbench/metrics/<metric>.py`` with a function
``read(ctx)``; every scene generator a module ``l3dbench/scenes/<name>.py``;
every kernel count a module ``l3dbench/counts/<kernel>.py`` with a function
``count(x)``.  Adding a cell, a configuration or a metric adds files and
entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(BENCHMARK)


def _module(kind: str, name: str):
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"l3dbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str):
    """The reader module of per-layer metric ``name``."""
    return _module("metrics", name)


def kernel_count(name: str):
    """The count module of kernel ``name`` (``count(x) -> (ops, bytes)``)."""
    return _module("counts", name)


def generator(name: str):
    """The scene generator module ``name``."""
    return _module("scenes", name)


def cell(name: str, bench: dict | None = None) -> dict:
    """Everything one cell needs, found from its name: ``entry`` (its line
    in ``BENCHMARK.json``), ``spec`` (its workload file), ``config`` (its
    configuration's file), the end-to-end metrics it reports and its
    per-layer metrics."""
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    spec = load_json(os.path.join(HERE, "workloads", f"{name}.json"))
    if spec["config"] != entry["config"]:
        raise ValueError(f"{name}: workload file names config "
                         f"{spec['config']!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    config = load_json(os.path.join(ROOT, conf["file"]))
    in_cell = lambda m: name in m.get("workloads", [name])
    return dict(name=name, entry=entry, spec=spec, config=config,
                end_to_end=[m for m in bench["end_to_end"] if in_cell(m)],
                per_layer=[m for m in bench["per_layer"] if in_cell(m)])
