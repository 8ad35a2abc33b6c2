"""Find a cell's configuration, traffic mix, driver and metric readers by the
names in ``BENCHMARK.json``.

A configuration is the JSON file its ``configs`` entry names; a traffic mix
is ``traffic/<mix>.json``; the mix names its driver, ``drivers/<driver>.py``
(a module with ``run(ctx)``); a per-layer metric is ``metrics/<metric>.py``
(a module with ``read(record)``). Adding a cell, a mix, a driver or a metric
adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def load_benchmark() -> Dict[str, Any]:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def _by_name(entries: List[Dict[str, Any]], name: str, what: str):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    """The configuration file's JSON, as it is run."""
    entry = _by_name(bench["configs"], name, "configuration")
    return json.loads((REPO / entry["file"]).read_text())


def traffic(name: str) -> Dict[str, Any]:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _module(kind: str, name: str) -> ModuleType:
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1]} file {path.name} under portbench/"
                       f"{kind}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str) -> ModuleType:
    return _module("drivers", name)


def metric_reader(name: str):
    return _module("metrics", name).read


def end_to_end(bench: Dict[str, Any], cell: str) -> List[Dict[str, Any]]:
    """The end-to-end metrics this cell reports: those that list it, and
    those that list no cells."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer(bench: Dict[str, Any], cell: str) -> List[Dict[str, Any]]:
    """The per-layer metrics this cell reports: those that list it, and
    those that list no cells but move an end-to-end metric it reports."""
    reported = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]
