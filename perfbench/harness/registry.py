"""Finds the benchmark's parts by name.

Every configuration, traffic mix, cell and metric is a file of its own:

    perfbench/configs/<config>.json     sizes and guarantees of a deployment
    perfbench/traffic/<mix>.json        parameters of a traffic mix; its
                                        ``kind`` names the general driver
                                        ``perfbench/drivers/<kind>.py``
    perfbench/cells/<cell>.json         config, mix, chips, correctness limits
    perfbench/metrics/<metric>.py       ``read(record) -> float | None``
    perfbench/archs/<architecture>.py   what the training driver and the
                                        readers need of a language model's
                                        architecture (its ``architecture``)
    perfbench/reference/<name>.py       a plain reference, named by a
                                        configuration's ``reference`` path

``BENCHMARK.json`` at the root of the checkout lists which metrics a cell
reports. Adding a cell, a mix or a metric adds files and entries; no file
here needs an edit.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: Path) -> Dict[str, Any]:
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} does not exist")
    with path.open() as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return _json(root / "BENCHMARK.json")


def config(name: str) -> Dict[str, Any]:
    return _json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name: str) -> Dict[str, Any]:
    return _json(BENCH_DIR / "traffic" / f"{name}.json")


def cell(name: str) -> Dict[str, Any]:
    return _json(BENCH_DIR / "cells" / f"{name}.json")


def driver(kind: str):
    """The driver module of a traffic ``kind`` (``drivers/<kind>.py``)."""
    if not (BENCH_DIR / "drivers" / f"{kind}.py").is_file():
        raise FileNotFoundError(f"no driver perfbench/drivers/{kind}.py")
    return importlib.import_module(f"perfbench.drivers.{kind}")


def arch(name: str):
    """The architecture module ``archs/<name>.py``."""
    if not (BENCH_DIR / "archs" / f"{name}.py").is_file():
        raise FileNotFoundError(f"no architecture perfbench/archs/{name}.py")
    return importlib.import_module(f"perfbench.archs.{name}")


def reference(path: str):
    """The plain reference module at ``path`` (a configuration's
    ``reference``, relative to the checkout: ``perfbench/reference/*.py``)."""
    rel = Path(path)
    if (rel.parent != Path("perfbench/reference") or rel.suffix != ".py"
            or not (ROOT / rel).is_file()):
        raise FileNotFoundError(f"no plain reference {path}")
    return importlib.import_module(f"perfbench.reference.{rel.stem}")


def metric_reader(name: str):
    """``read(record)`` of ``metrics/<name>.py`` (names may hold dots)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no metric reader {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: Dict[str, Any], workload: str, traced: bool
                ) -> List[Dict[str, Any]]:
    """The metric entries a run of ``workload`` reports: its end-to-end
    metrics untraced, its per-layer metrics traced. An entry without a
    ``workloads`` key belongs to every cell that reports its ``moves``
    (per-layer) or to every cell (end-to-end)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in names]
