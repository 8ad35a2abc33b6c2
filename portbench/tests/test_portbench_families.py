"""Model families, found by the configuration's architecture.

The Llama family gives the same weight tree, operation counts, K3 calls
and reference logits as the shared modules gave before the family was
split out of them (values recorded from that code at the same tiny
configurations and seed). A family for the tests alone (``twin/``), the
Llama family under another name with a kernel class of its own, runs a
cell end to end on the CPU without an edit to a shared module."""

import contextlib
import hashlib
import time

import numpy as np
import pytest
import torch

from portbench import registry, roofline, run, trace, weights
from portbench.families import llama
from portbench.reference import common

from . import _tiny

SEED = 2 ** 31 + 5
TWIN = registry.HERE / "tests" / "twin"

CASES = {"qwen2": {}, "plain": {"qkv_bias": False,
                                "use_sliding_window": False}}
# sha256 of every leaf (path, dtype, shape, bytes) and the bytes in all
TREES = {
    "qwen2": (("a3343949b1c588a8b83d87b2c33e4eb621de27e12afd3e59473b3bcc"
               "26e2c0e9", 149760),
              ("e1bd945f3762338f5476a06b337d4b21185f1e050401af6d8f7cb6e7"
               "e8f6c062", 25088)),
    "plain": (("bff4c5a50f5985ebdec26ac4732211fa7cd0fb8edba822c65f94dc20"
               "16db040b", 148736),
              ("92b056e19e449e99d1d32f92b778dcabe23279f0e05ddae8a9fc6d90"
               "65c9da83", 25088)),
}
# forward_flops at ([8, 0, 3], [40, 0, 100], 2) and ([1, 1, 1], [5, 60,
# 200], 3); K3's (operations, bytes) at ([40, 100], S 8) and ([5, 60,
# 200], S 1), two layers
FLOPS = {"qwen2": (2009088.0, 691200.0), "plain": (2092032.0, 776192.0)}
K3 = {"qwen2": ((189440.0, 17280.0), (26112.0, 13824.0)),
      "plain": ((305152.0, 24064.0), (68608.0, 35072.0))}
# logits at positions 0, 47 and 63 of one 64-token sequence: each row's
# norm, its largest entry and its product with cos(0 .. V - 1)
LOGITS = {
    "qwen2": ((92.04562242986293, 12.293205261230469, 124.77794340293106),
              (93.53696525196348, 12.074263572692871, 38.20093155317413),
              (89.04436598760181, 12.04538345336914, 46.556310942452946)),
    "plain": ((87.46109631716361, 14.197212219238281, 51.473322696409795),
              (89.30709703331306, 11.055098533630371, -46.19562485619707),
              (89.77268661469466, 13.811159133911133, -112.19075125703716)),
}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _digest(tree):
    h, n = hashlib.sha256(), 0
    for path, t in _leaves(tree):
        t = t.contiguous()
        h.update(f"{path} {t.dtype} {tuple(t.shape)}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
        n += t.numel() * t.element_size()
    return h.hexdigest(), n


def test_llama_runs_the_configurations_architectures():
    c = _tiny.config()
    assert c["architectures"] == ["Qwen2ForCausalLM"]
    assert registry.family(c).ARCHITECTURES == llama.ARCHITECTURES
    assert registry.family(c).KERNEL_CLASSES == ()


@pytest.mark.parametrize("case", sorted(CASES))
def test_weight_tree_is_unchanged(case):
    c = _tiny.config(**CASES[case])
    p = weights.make(registry.family(c), c, SEED, "cpu")
    assert set(p) == {"llama", "connector"}
    assert (_digest(p["llama"]), _digest(p["connector"])) == TREES[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_counts_are_unchanged(case):
    c = _tiny.config(**CASES[case])
    assert llama.forward_flops(c, [8, 0, 3], [40, 0, 100], 2) == \
        FLOPS[case][0]
    assert llama.forward_flops(c, [1, 1, 1], [5, 60, 200], 3) == \
        FLOPS[case][1]
    assert llama.kernel_calls(c, [40, 100], 8) == {"K3": (*K3[case][0], 2)}
    assert llama.kernel_calls(c, [5, 60, 200], 1) == \
        {"K3": (*K3[case][1], 2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_logits_are_unchanged(case):
    c = _tiny.config(**CASES[case])
    fam = registry.family(c)
    tree = weights.make(fam, c, SEED, "cpu")["llama"]
    common.exact_fp32()
    ids = torch.arange(64) * 7 % c["vocab_size"]
    with torch.no_grad():
        e = fam.reference.embed_ids(tree, ids)
        h = fam.reference.final_hidden(tree, c, [e])[0]
        lg = fam.reference.logits(tree, h[[0, 47, 63]]).double()
    w = torch.cos(torch.arange(lg.shape[1], dtype=torch.float64))
    for row, want in zip(lg, LOGITS[case]):
        got = (float(row.norm()), float(row.max()), float(row @ w))
        assert got == pytest.approx(want, rel=0, abs=1e-6 * want[0])


def test_meter_bounds_each_kernel_class():
    """``FlopMeter.kernel_bounds`` over the family's ``kernel_calls``: K3's
    least time a layer, times the layers, for each forward with a valid
    stream (one with none is left out)."""
    c = _tiny.config()
    meter = registry.driver("serve_backlog").FlopMeter(llama, c)
    meter.calls = [(np.array([40, 100]), 8), (np.array([], np.int64), 8),
                   (np.array([5, 60, 200]), 1)]
    (s0, k0), (s1, k1) = (roofline.least_time(*K3["qwen2"][0]),
                          roofline.least_time(*K3["qwen2"][1]))
    assert k0 == k1 == "bytes"
    assert meter.kernel_bounds() == {
        "K3": {"bound_s": s0 * 2 + s1 * 2, "calls": 4, "kind": "bytes"}}


def test_unknown_architecture_raises_before_any_weight(monkeypatch):
    c = _tiny.config(architectures=["NoSuchForCausalLM"])
    with pytest.raises(KeyError, match="NoSuchForCausalLM"):
        registry.family(c)

    def no_weights(*a, **k):
        raise AssertionError("weights made for an unknown architecture")

    monkeypatch.setattr(weights, "make", no_weights)
    b = _tiny.bench("tiny.serve", "qwen2-7b-int8", "narrate64",
                    "qwen2-7b-int8.narrate64")
    with pytest.raises(KeyError, match="NoSuchForCausalLM"):
        run.run_cell("tiny.serve", SEED, 1.0, False, device="cpu", bench=b,
                     config=c, mix=_tiny.serve_mix(), t0=time.perf_counter())


def test_two_families_for_one_architecture_raise(monkeypatch, tmp_path):
    (tmp_path / "families").mkdir()
    (tmp_path / "families" / "again.py").write_text(
        'ARCHITECTURES = ("Qwen2ForCausalLM",)\n')
    monkeypatch.setattr(registry, "ROOTS", (registry.HERE, tmp_path))
    with pytest.raises(KeyError, match="Qwen2ForCausalLM"):
        registry.family(_tiny.config())


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# a CPU run records no device operation: the profiled sub-window reads
# these, a 1000 us window busy 200 us in the twin's kernel and 600 in a
# product
EVENTS = [_ev("user_annotation", trace.WINDOW, 0, 1000),
          _ev("kernel", "void twin_attn_kernel<128, PagedPool<bf16> >()",
              100, 200),
          _ev("kernel", "nvjet_tst_64x8", 300, 600)]


@contextlib.contextmanager
def _profiled(out_dir, sync, kernel_classes=()):
    out = {}
    yield out
    out["summary"] = trace.summarize(EVENTS, kernel_classes)
    out["read_s"] = 0.0


def test_twin_family_is_new_files_only(monkeypatch):
    monkeypatch.setattr(registry, "ROOTS", (registry.HERE, TWIN))
    monkeypatch.setattr(trace, "profiled", _profiled)
    c = _tiny.config(architectures=["TwinForCausalLM"])
    fam = registry.family(c)
    assert fam.ARCHITECTURES == ("TwinForCausalLM",)
    b = _tiny.bench("tiny.twin", "qwen2-7b-int8", "narrate64",
                    "qwen2-7b-int8.narrate64")
    b["per_layer"].append({"name": "twin_roofline", "unit": "%",
                           "better": "higher", "source": "device_trace",
                           "layer": "kernel Ktwin", "moves": "frames_per_s",
                           "workloads": ["tiny.twin"]})
    out = run.run_cell("tiny.twin", SEED, 1.5, True, device="cpu", bench=b,
                       config=c, mix=_tiny.serve_mix(),
                       t0=time.perf_counter())
    assert out["correct"] and out["failed"] == 0
    # the family's class comes before the shared ones: the kernel names
    # PagedPool, which is K3's
    assert out["_summary"]["classes"]["Ktwin"] == [pytest.approx(2e-4), 1]
    assert "K3" not in out["_summary"]["classes"]
    assert out["breakdown"]["device_ops"][1][0] == "Ktwin"
    # its metric reads the bound the meter counted under its class; K3's
    # reads nothing
    m = out["metrics"]
    assert m["twin_roofline"]["value"] > 0
    assert m["twin_roofline"]["bound"] in ("operations", "bytes")
    assert "k3_roofline" not in m
    assert m["mfu.serve"]["value"] > 0
