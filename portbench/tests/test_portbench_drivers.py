"""The serving driver and its reference end to end at a tiny size on the
CPU, through the port's plain ops; the harness's look for a card is skipped
(``run.run_cell`` with ``device="cpu"``). A sound run is correct; each
fault the cell can have, planted under the timed path, makes ``correct``
false; the fp8 control reads far above the program."""

import time

import numpy as np
import pytest
import torch

from portbench import run

from . import _tiny

SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _serve(patch=None, control=False, seconds=1.5, **mix):
    b = _tiny.bench("tiny.serve", "qwen2-7b-int8", "narrate64",
                    "qwen2-7b-int8.narrate64")
    return run.run_cell("tiny.serve", SEED, seconds, False, device="cpu",
                        bench=b, config=_tiny.config(),
                        mix=_tiny.serve_mix(**mix), control=control,
                        patch=patch,
                        t0=time.perf_counter())


def test_serve_sound_run_is_correct():
    out = _serve()
    assert out["correct"] and out["failed"] == 0
    ck, st = out["checks"], out["_stats"]
    assert ck["served_tokens"]["value"] > 0
    assert ck["judged_gates"]["value"] > 0
    assert set(ck) == {"max_gap", "mean_gap", "gate_gap", "served_tokens",
                       "judged_gates", "probes_unanswered"}
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    # fp32 both sides on the CPU: the same tokens and gate margins
    assert ck["mean_gap"]["value"] < 1e-4
    assert ck["gate_gap"]["value"] < 1e-3
    assert st["gates"] == ck["judged_gates"]["value"]


def test_serve_control_takes_the_programs_place():
    """With the control on, its readings are the ones compared (under
    their own names) and the program's stay in the stats; at this size
    the control reads far above the program."""
    out = _serve(control=True)
    ck, st = out["checks"], out["_stats"]
    assert {"control_max_gap", "control_mean_gap",
            "control_gate_gap"} <= set(ck)
    assert "mean_gap" not in ck
    for name in ("mean_gap", "gate_gap"):
        assert ck[f"control_{name}"]["value"] == st[f"control_{name}"]
        assert st[f"control_{name}"] > 3 * st[name]
    assert out["correct"] == all(
        v["value"] <= v["limit"] for k, v in ck.items()
        if k.startswith("control_"))


def _altered_token(eng):
    orig = eng._respond

    def bad(*a, **k):
        out, lengths = orig(*a, **k)
        out = out.copy()
        out[:, 1] = (out[:, 1] + 1) % 512
        return out, lengths
    eng._respond = bad


def _half_batch(eng):
    orig = eng._fwd

    def bad(embeds, num_valid, *a, **k):
        nv = np.asarray(num_valid).copy()
        half = len(nv) // 2 + 1
        # the ingest forwards of the first streams write nothing
        nv[:half] = np.where(nv[:half] > 20, 0, nv[:half])
        return orig(embeds, nv, *a, **k)
    eng._fwd = bad


def _state_unchanged(eng):
    orig = eng._dispatch_ingest

    def bad(coll):
        e = orig(coll)
        eng.cache.k.zero_()
        eng.cache.v.zero_()
        return e
    eng._dispatch_ingest = bad


def _wrong_gate_row(eng):
    orig = eng._fwd

    def bad(embeds, num_valid, gather_pos=None, *a, **k):
        # the chunked ingest's gates read the token before each frame's end
        if gather_pos is not None and gather_pos.dim() == 2:
            gather_pos = (gather_pos - 1).clamp(min=0)
        return orig(embeds, num_valid, gather_pos, *a, **k)
    eng._fwd = bad


@pytest.mark.parametrize("fault,reading", [
    (_altered_token, "mean_gap"), (_half_batch, "mean_gap"),
    (_state_unchanged, "mean_gap"), (_wrong_gate_row, "gate_gap")])
def test_serve_fault_is_caught(fault, reading):
    # every dialogue judged, so that the streams a fault spares cannot make
    # up the whole sample
    out = _serve(patch=fault, sample_dialogues=99)
    assert not out["correct"]
    assert out["failed"] > 0
    assert out["checks"][reading]["value"] > \
        out["checks"][reading]["limit"]

