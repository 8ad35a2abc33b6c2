"""Discovery by name, the contract's shapes of BENCHMARK.json, and the run's
refusal without a card."""

import json
import re

import pytest

from portbench import registry, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return registry.load_benchmark()


def test_every_cell_finds_its_files(bench):
    for cell in bench["workloads"]:
        cfg = registry.config(bench, cell["config"])
        assert cfg["name"] == cell["config"]
        assert cfg["architectures"][0] in registry.family(cfg).ARCHITECTURES
        mix = registry.traffic(cell["traffic"])
        assert hasattr(registry.driver(mix["driver"]), "run")
        assert registry.end_to_end(bench, cell["name"])
        assert registry.per_layer(bench, cell["name"])
    for m in bench["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))


def test_missing_names_raise(bench):
    with pytest.raises(KeyError):
        registry.workload(bench, "no-such-cell")
    with pytest.raises(KeyError):
        registry.driver("no_such_driver")
    with pytest.raises(KeyError):
        registry.metric_reader("no_such_metric")


def test_contract_shapes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for sec in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in bench[sec]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in cells
            assert m["moves"] in {x["name"] for x in
                                  registry.end_to_end(bench, w)}
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    assert len(json.dumps(bench)) < 64 * 1024


def test_configs_keep_every_width(bench):
    for entry in bench["configs"]:
        c = registry.config(bench, entry["name"])
        assert c["reduced"] == entry["reduced"] == []
        assert c["hidden_size"] == c["num_attention_heads"] * c["head_dim"]


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", "qwen2-7b-int8.narrate64", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
