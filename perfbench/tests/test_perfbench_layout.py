"""Every part BENCHMARK.json names resolves by name, and the file keeps
to the benchmark's contract (names, units, keys, sources)."""
import json
import re

import pytest

from perfbench.harness import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    spec = registry.cell(cell)
    for key in ("config", "traffic", "chips"):
        assert spec[key] == entry[key]
    cfg = registry.config(entry["config"])
    traffic = registry.traffic(entry["traffic"])
    assert registry.driver(traffic["kind"]).Driver
    assert spec["limits"] and all(v >= 0 for v in spec["limits"].values())
    assert cfg["name"] == entry["config"]
    assert entry["chips"] == 1
    assert len(entry["why"]) <= 200
    reported = registry.metrics_for(BENCH, cell, False)
    assert {m["name"] for m in reported} >= {"setup_s"}
    assert len(reported) >= 2
    assert registry.metrics_for(BENCH, cell, True)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_resolves(metric):
    m = {x["name"]: x for x in METRICS}[metric]
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(registry.metric_reader(metric))
    for w in m.get("workloads", []):
        assert w in CELLS


def test_contract_shapes():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert set(c["reduced"]) <= set(registry.config(c["name"]))
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                           "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for w in BENCH["workloads"]:
        e2e = registry.metrics_for(BENCH, w["name"], False)
        assert any(m["name"] != "setup_s" for m in e2e)
