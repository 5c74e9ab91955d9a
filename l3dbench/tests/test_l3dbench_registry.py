"""The harness finds every cell, configuration, metric, generator and
kernel count by its name, and BENCHMARK.json keeps to its format."""

import json
import os
import re

import pytest

from l3dbench import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_with_its_parts(name):
    cell = registry.cell(name)
    assert cell["spec"]["name"] == name
    assert cell["config"]["name"] == cell["entry"]["config"]
    gen = registry.generator(cell["config"]["generator"])
    assert hasattr(gen, "Source")
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in e2e
    for key in ("entry", "options", "sample", "trace_scenes", "limits"):
        assert key in cell["spec"]


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(name):
    assert callable(registry.metric(name).read)


@pytest.mark.parametrize("name", ["K1", "K2", "K3"])
def test_every_kernel_count_is_found(name):
    assert callable(registry.kernel_count(name).count)


def test_every_config_file_lies_under_paths_and_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        conf = registry.load_json(os.path.join(registry.ROOT, c["file"]))
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]


def test_the_file_keeps_to_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 << 10
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in metrics:
        assert set(m.get("workloads", cells)) <= cells
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
