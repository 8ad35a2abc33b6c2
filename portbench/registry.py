"""Find a cell's configuration, model family, traffic mix, driver and
metric readers by the names in ``BENCHMARK.json``.

A configuration is the JSON file its ``configs`` entry names; its family is
the module of ``families/`` whose ``ARCHITECTURES`` holds the
configuration's ``architectures[0]``; a traffic mix is
``traffic/<mix>.json``; the mix names its driver, ``drivers/<driver>.py``
(a module with ``run(ctx)``); a per-layer metric is ``metrics/<metric>.py``
(a module with ``read(record, info)``). Adding a cell, a mix, a driver, a
metric or a family adds files and entries and edits none.

A family (``families/<family>.py``; ``llama.py`` is one) is everything the
benchmark knows of one kind of decoder. It provides:

- ``ARCHITECTURES``: the Hugging Face ``architectures`` names it runs; no
  two families share one.
- ``KERNEL_CLASSES``: ``(class, match)`` pairs, ``match`` taking a
  lowercased kernel name, tried before ``trace.CLASSES``: the kernels of
  its own that a roofline metric reads.
- ``reference``: its plain fp32 decoder, a module under ``reference/`` that
  reaches nothing of the port, with ``embed_ids(tree, ids)``,
  ``final_hidden(tree, c, seqs, rnd)`` and ``logits(tree, hidden, rnd)``
  over the decoder's tree (``reference/decoder.py`` is Llama's).
- ``live_config(c, *, max_response_tokens, gate_logit_bias)``: the port's
  ``LiveConfig`` for configuration ``c``.
- ``make_decoder(c, g, device)``: the decoder's weight tree, drawn from the
  generator ``g``, in the layout the port takes.
- ``forward_flops(c, num_valid, offsets, head_rows)``: the operations one
  serving forward must do, for the rows with valid tokens.
- ``kernel_calls(c, offsets, S)``: ``{class: (operations, bytes, layers)}``
  of one forward's calls, for the streams with valid tokens.
- ``port_forward()``: ``(module, attribute)`` of the port's forward that
  ``FlopMeter`` wraps; it reads the engine's call keywords.

A new kernel's roofline metric is a file ``metrics/<kernel>_roofline.py``
whose ``read`` returns ``_share.kernel_roofline(rec, info, "<class>")``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# directories that hold families/, drivers/ and metrics/, searched in order
# (the tests add one of their own)
ROOTS = (HERE,)


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


def _load(path: Path, kind: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{path.stem.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _module(kind: str, name: str) -> ModuleType:
    for root in ROOTS:
        path = root / kind / f"{name}.py"
        if path.is_file():
            return _load(path, kind)
    raise KeyError(f"no {kind[:-1]} file {name}.py under portbench/{kind}")


def family(c: Dict[str, Any]) -> ModuleType:
    """The family module that runs configuration ``c``: the one whose
    ``ARCHITECTURES`` holds ``c["architectures"][0]``."""
    arch = c["architectures"][0]
    found = []
    for root in ROOTS:
        for path in sorted((root / "families").glob("[!_]*.py")):
            mod = _load(path, "families")
            if arch in mod.ARCHITECTURES:
                found.append(mod)
    if len(found) != 1:
        raise KeyError(f"{len(found)} families under portbench/families run "
                       f"the architecture {arch!r}; one must")
    return found[0]


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
