"""The port's MultiStreamEngine phases and counters.

One tiny engine a mode (the blocking tick over the ring, over the paged
pool, speculative decode, the pipelined tick over the paged pool) is
driven once per module through a scripted schedule: a first stretch with
no profiler running and ``record_function`` counted, where one stream of
three answers a query; then, under ``torch.profiler`` (CPU), a closed
stream refed and two streams answering in one respond program. The tests
read the trace's spans and hold ``counters()`` to a count made from what
each respond program returned.
"""

import json

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from videollm_online_tpu_torch.core.config import tiny_live_config
from videollm_online_tpu_torch.models import live
from videollm_online_tpu_torch.serve.multistream import MultiStreamEngine
from videollm_online_tpu_torch.tokenizer.live_tokenizer import LiveTokenizer
from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer

N = 3
BUDGET = 6
OUTER = ("multistream.admit", "multistream.ingest", "multistream.settle",
         "multistream.respond", "multistream.input", "multistream.close")
MODES = {
    "ring": dict(paged=False, kv_capacity=512),
    "paged": dict(paged=True, kv_capacity=512, page_size=64),
    "spec": dict(paged=False, kv_capacity=512, spec_decode=True),
    "pipelined": dict(paged=True, kv_capacity=512, page_size=64,
                      pipelined=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work (the suite runs its
    files in parallel processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    # the gate bias holds every gate at the interval token: only the
    # queries answer
    tok = LiveTokenizer(ByteTokenizer(), tiny_live_config())
    cfg = tok.cfg.replace(max_response_tokens=BUDGET, gate_logit_bias=60.0)
    params = live.init_params(torch.Generator().manual_seed(3), cfg,
                              device="cpu")
    return cfg, tok, params


def _feats(cfg, n, seed):
    return np.random.RandomState(seed).randn(
        n, cfg.frame_num_tokens, cfg.vision_hidden_size).astype(np.float32)


def _drain(ms, max_ticks=48):
    for _ in range(max_ticks):
        ms.step()
        if not ms.pending():
            return
    raise AssertionError("engine did not drain")


def _user_spans(path):
    """(name, start, end) of every ``multistream.*`` range in the exported
    chrome trace, in microseconds."""
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("multistream.")]


@pytest.fixture(scope="module", params=sorted(MODES))
def run(request, setup, tmp_path_factory):
    cfg, tok, params = setup
    ms = MultiStreamEngine(params, tok, cfg, num_streams=N, device="cpu",
                           **MODES[request.param])
    # what each respond program returned: (active rows, lengths)
    programs = []
    respond = ms._respond

    def recorded(ids, nv, active, hist_nv=None):
        out, lengths = respond(ids, nv, active, hist_nv)
        programs.append((active.copy(), np.asarray(lengths).copy()))
        return out, lengths

    ms._respond = recorded
    fps = ms.frame_fps
    rec = {"mode": request.param}

    calls = []
    orig = autograd_profiler.record_function

    def counted(*a, **k):
        calls.append(a)
        return orig(*a, **k)

    autograd_profiler.record_function = counted
    try:
        # 1. no profiler: stream 0 asks at its frame 0
        for i in range(N):
            ms.input_frames(i, 0.0, _feats(cfg, 3, i))
        ms.input_query(0, "what now?", 0.0)
        _drain(ms)
        rec["calls_off"] = len(calls)
        rec["first"] = list(programs)
        rec["counters_1"] = ms.counters()
        rec["phases_1"] = ms.stats()["phases"]

        # 2. under the profiler: stream 0 closed and refed, streams 1 and 2
        # asked at their next frame, answered in one respond program
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            ms.close_stream(0)
            ms.input_frames(0, 0.0, _feats(cfg, 2, 7))
            for i in (1, 2):
                t = 3 / fps
                ms.input_frames(i, t, _feats(cfg, 2, 10 + i))
                ms.input_query(i, "and now?", t)
            _drain(ms)
        rec["calls_on"] = len(calls) - rec["calls_off"]
    finally:
        autograd_profiler.record_function = orig
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    rec["spans"] = _user_spans(path)
    rec["second"] = programs[len(rec["first"]):]
    rec["counters"] = ms.counters()
    rec["spec"] = ms.spec_stats()
    rec["stats"] = ms.stats()
    rec["paged"] = ms.paged
    return rec


def _expected(programs):
    """The counters a respond program's returned lengths imply: a stream
    of final length L is fed in decode forwards 1 .. L - 1, and a program
    runs max(L) - 1 of them, each over all N rows; on the CPU none of them
    captures or replays a CUDA graph."""
    c = dict(respond_programs=0, decode_forwards=0, decode_rows=0,
             decode_rows_valid=0, decode_graph_captures=0,
             decode_graph_replays=0)
    for active, lengths in programs:
        steps = int(lengths[active].max()) - 1
        c["respond_programs"] += 1
        c["decode_forwards"] += steps
        c["decode_rows"] += N * steps
        c["decode_rows_valid"] += int((lengths[active] - 1).sum())
    return c


def test_spans_on_the_profiler_timeline(run):
    spans = run["spans"]
    names = {n for n, _, _ in spans}
    want = set(OUTER) | {"multistream.respond.prefill",
                         "multistream.respond.decode"}
    if run["paged"]:
        want.add("multistream.pages")
    assert want <= names, sorted(want - names)
    outer = [s for s in spans if s[0] in OUTER]
    for k, (na, a0, a1) in enumerate(outer):
        for nb, b0, b1 in outer[k + 1:]:
            assert not (a0 <= b0 and b1 <= a1) and \
                not (b0 <= a0 and a1 <= b1), (na, nb)
    responds = [s for s in spans if s[0] == "multistream.respond"]
    decodes = [s for s in spans if s[0] == "multistream.respond.decode"]
    for _, d0, d1 in decodes:
        assert any(r0 <= d0 and d1 <= r1 for _, r0, r1 in responds)
    # every decode forward of the profiled stretch is one span
    forwards = (run["counters"]["decode_forwards"]
                - run["counters_1"]["decode_forwards"])
    assert len(decodes) == forwards > 0


def test_no_record_function_without_a_profiler(run):
    assert run["calls_off"] == 0
    # that stretch ran an ingest and a respond program, and the same
    # counting sees the spans once a profiler records
    assert run["counters_1"]["respond_programs"] == 1
    assert run["phases_1"]["multistream.ingest"]["count"] >= 1
    assert run["phases_1"]["multistream.respond.decode"]["count"] >= 1
    assert run["calls_on"] >= len(run["spans"]) > 0


def test_counters_equal_a_hand_count(run):
    (a1, _), = run["first"]
    (a2, _), = run["second"]
    # no mode records a CUDA graph on the CPU
    assert run["counters"]["decode_graph_captures"] == 0
    # one stream answering of N, then two
    assert a1.tolist() == [True, False, False]
    assert a2.tolist() == [False, True, True]
    c = run["counters"]
    if run["mode"] != "spec":
        assert run["counters_1"] == _expected(run["first"])
        assert c == _expected(run["first"] + run["second"])
        return
    # a verify forward emits up to spec_draft + 1 tokens a row; the spec
    # stats count the prompt's rows and then every verify forward's live
    # rows
    prompt_rows = sum(int(a.sum()) for a, _ in run["first"] + run["second"])
    assert c["respond_programs"] == 2 and c["decode_forwards"] >= 1
    assert c["decode_rows"] == N * c["decode_forwards"]
    assert int(run["spec"][0]) == prompt_rows + c["decode_rows_valid"]


def test_stats_carry_phases_and_counters(run):
    st = run["stats"]
    assert st["counters"] == run["counters"]
    assert "tick" not in st["phases"] and st["ticks"]["count"] >= 1
    for name in OUTER:
        p = st["phases"][name]
        assert p["count"] >= 1 and p["p50_ms"] <= p["p90_ms"] <= p["p99_ms"]
