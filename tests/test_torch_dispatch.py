"""The engines' dispatch-ahead drivers against their blocking paths.

``LiveInferEngine(speculative=True)`` dispatches frame i + 1 before frame
i's gate is read, ``pipelined=True`` burst i + 1 before burst i's, and
``MultiStreamEngine(pipelined=True)`` tick i + 1's batched ingest before
tick i's gates; a wrong guess is rolled back. Each case mirrors a test of
the JAX package's own drivers (tests/test_serve_engine.py,
tests/test_multistream.py) on the tiny config in fp32 on the CPU and holds
the port's mode against the port's blocking engine: transcripts, the tail
``flush()`` returns included, byte-equal, and the ring's offset and rows
(int8 codes and scales too), the pending prepend and the n-gram history
equal. On the CPU nothing runs ahead of the host, so these cases prove the
bookkeeping (rollbacks, queues, offsets, pages), not the overlap. Two
cases, one a driver, with gate fires and queries, also hold the port's
mode against the JAX engine in the same mode, byte-equal.
"""

import numpy as np
import pytest

import jax
import torch

from videollm_online_tpu.models import live as jax_live
from videollm_online_tpu.serve.engine import LiveInferEngine as JaxEngine
from videollm_online_tpu.serve.multistream import (
    MultiStreamEngine as JaxMultiStream)

from videollm_online_tpu_torch.core.config import tiny_live_config
from videollm_online_tpu_torch.core.device import DeferredRead, to_device
from videollm_online_tpu_torch.models import live
from videollm_online_tpu_torch.models.bridge import params_from_numpy
from videollm_online_tpu_torch.serve.engine import LiveInferEngine
from videollm_online_tpu_torch.serve.multistream import MultiStreamEngine
from videollm_online_tpu_torch.tokenizer.live_tokenizer import LiveTokenizer
from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer

from test_torch_engine import _configs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work (the suite runs its
    files in parallel processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(threshold, seed, budget=12, bias=0.0):
    tok = LiveTokenizer(ByteTokenizer(), tiny_live_config())
    cfg = tok.cfg.replace(frame_token_interval_threshold=threshold,
                          max_response_tokens=budget, gate_logit_bias=bias)
    params = live.init_params(torch.Generator().manual_seed(seed), cfg,
                              device="cpu")
    return cfg, tok, params


def _feats(cfg, n, seed):
    return np.random.RandomState(seed).randn(
        n, cfg.frame_num_tokens, cfg.vision_hidden_size).astype(np.float32)


def _run(engine, feats, frame_times, queries, flush=True):
    """The JAX tests' driver: feed each time's frames (and the queries due
    by then), call until a call answers nothing; then the flushed tail."""
    engine.load_video(feats)
    out, qi = [], 0
    for t in frame_times:
        while qi < len(queries) and queries[qi][0] <= t:
            engine.input_query_stream(queries[qi][1],
                                      video_time=queries[qi][0])
            qi += 1
        engine.input_video_stream(t)
        while True:
            q, r = engine()
            if r is None:
                break
            out.append((q, r))
    return out + engine.flush() if flush else out


def _assert_same_state(a, b):
    """Resolved ring offset, ring rows up to it (codes and scales), the
    pending prepend, the n-gram history and nothing in flight."""
    off = a._host_offset
    assert off == b._host_offset == int(a.cache.offset[0])
    pools = ("k", "v") + (("k_scale", "v_scale") if a.kv_quant else ())
    for name in pools:
        pa, pb = getattr(a.cache, name), getattr(b.cache, name)
        assert torch.equal(pa[:, :, :, :off], pb[:, :, :, :off]), name
    assert a._pending_prepend == b._pending_prepend
    assert torch.equal(a._hist, b._hist) and int(a._hcount) == int(b._hcount)
    assert a.stats()["inflight_speculative"] == 0
    assert a.stats()["inflight_pipelined"] == 0


def _pair(cfg, tok, params, mode, **kw):
    return (LiveInferEngine(params, tok, cfg, device="cpu", **mode, **kw),
            LiveInferEngine(params, tok, cfg, device="cpu", **kw))


# ----------------------------------------------------- realtime speculative
@pytest.mark.parametrize("queries", [
    [],                               # fires constantly: every speculative
                                      # dispatch rolls back
    [(0.5, "q1?"), (2.0, "q2?")],     # queries flush the pipeline
], ids=["fires", "queries"])
def test_speculative_content_equals_blocking(queries):
    cfg, tok, params = _setup(0.725, seed=6)
    feats = _feats(cfg, 10, 11)
    times = [i * 0.5 for i in range(10)]         # one frame per call
    a, b = _pair(cfg, tok, params, dict(speculative=True), kv_capacity=4096)
    ta, tb = _run(a, feats, times, queries), _run(b, feats, times, queries)
    assert ta == tb and len(ta) >= 1
    _assert_same_state(a, b)
    st = a.dispatch_stats()
    assert st["rolled_back"] >= 1 and st["max_inflight"] == 2


def test_speculative_with_stream_window_compaction():
    """The windowed speculative engine matches the windowed blocking engine
    through a stream long enough to compact the ring."""
    cfg, tok, params = _setup(0.725, seed=8)
    feats = _feats(cfg, 24, 13)
    times = [i * 0.5 for i in range(24)]
    window = 96
    cap = (window + 4 + 8 * (cfg.frame_num_tokens + 1) + 256
           + cfg.max_response_tokens)
    a, b = _pair(cfg, tok, params, dict(speculative=True), kv_capacity=cap,
                 stream_window=window)
    ta = _run(a, feats, times, [(5.0, "mid?")])
    tb = _run(b, feats, times, [(5.0, "mid?")])
    assert ta == tb and len(ta) >= 1
    assert int(a.cache.pos_base[0]) > 0, "the ring never compacted"
    _assert_same_state(a, b)


# -------------------------------------------------------- sustained pipelined
@pytest.mark.parametrize("queries,feed_every,rolls", [
    ([], 4, True),                           # the gate fires inside bursts
    ([(0.5, "q1?"), (3.0, "q2?")], 4, True),  # query turns end the pipe
    ([(2.0, "mid?")], 8, False),             # bigger bursts
], ids=["fires", "queries", "bursts_of_8"])
def test_pipelined_content_equals_blocking(queries, feed_every, rolls):
    cfg, tok, params = _setup(0.725, seed=9)
    feats = _feats(cfg, 16, 17)
    times = [(i + 1) * feed_every * 0.5 - 0.5 for i in range(16 // feed_every)]
    a, b = _pair(cfg, tok, params, dict(pipelined=True), kv_capacity=4096)
    ta, tb = _run(a, feats, times, queries), _run(b, feats, times, queries)
    assert ta == tb and len(ta) >= 1
    _assert_same_state(a, b)
    assert (a.dispatch_stats()["rolled_back"] >= 1) == rolls


def test_pipelined_tight_ring_progress():
    """A ring with room for the stream but not for two bursts' worst case
    in flight degrades to the blocking step and keeps consuming frames
    through the public __call__ loop alone."""
    cfg, tok, params = _setup(0.725, seed=3, bias=50.0)  # pinned no-fire
    feats = _feats(cfg, 24, 5)
    start = len(LiveInferEngine(params, tok, cfg, kv_capacity=4096,
                                device="cpu")._start_ids)
    cap = (start + 24 * (4 + cfg.frame_num_tokens) + 32
           + cfg.max_response_tokens + 16)
    a, b = _pair(cfg, tok, params, dict(pipelined=True), kv_capacity=cap)
    for eng in (a, b):
        eng.load_video(feats)
        for t in [3.5, 7.5, 11.5]:
            eng.input_video_stream(t)
            for _ in range(50):  # __call__-only driver: no flush
                if eng() == (None, None) and not eng._inflight:
                    break
        assert not eng.frame_embeds_queue, "frames stuck: no progress"
    _assert_same_state(a, b)


def _ingest_layouts(engine):
    """Record every ingest forward ``engine`` dispatches (a chunk's frame
    count, or 0 for a single-frame forward) and which of them a rollback
    discards. Returns a function giving the layouts kept so far."""
    seen, dropped = [], set()
    ingest, rollback = engine._ingest, engine._rollback

    def record(first_ids, times, frames, threshold, *, chunk, **kw):
        e = ingest(first_ids, times, frames, threshold, chunk=chunk, **kw)
        seen.append((e, len(frames) if chunk else 0))
        return e

    def drop(e, consumed):
        dropped.update(id(n) for n in engine._inflight)
        rollback(e, consumed)

    engine._ingest, engine._rollback = record, drop
    return lambda: [n for e, n in seen if id(e) not in dropped]


@pytest.mark.parametrize("bias", [50.0, 0.0], ids=["no_fire", "fires"])
def test_pipelined_forward_layout_equals_blocking(bias):
    """A 9-frame backlog goes out in the blocking step's forwards: a chunk
    of 8 and a chunk of 1 (not a single-frame forward, another shape), and
    after a rollback the re-queued frames are chunked as the blocking step
    chunks them. The forwards a rollback discards aside, the sequence of
    ingest layouts is the blocking engine's."""
    cfg, tok, params = _setup(0.725, seed=9, bias=bias)
    feats = _feats(cfg, 9, 17)
    a, b = _pair(cfg, tok, params, dict(pipelined=True), kv_capacity=4096)
    seqs = [_ingest_layouts(x) for x in (a, b)]
    ta, tb = _run(a, feats, [4.0], []), _run(b, feats, [4.0], [])
    assert ta == tb
    assert seqs[0]() == seqs[1]()
    if bias:
        assert seqs[1]() == [8, 1] and not ta
    else:
        assert a.dispatch_stats()["rolled_back"] >= 1 and ta
    _assert_same_state(a, b)


@pytest.mark.parametrize("mode", ["speculative", "pipelined"])
def test_dispatch_int8_ring_spec_decode(mode):
    """The int8 ring's codes and scales rewind with its offset, and the
    n-gram history of spec decode reads as the blocking engine's after
    rollbacks (ingest never writes it)."""
    cfg, tok, params = _setup(0.725, seed=4)
    feats = _feats(cfg, 12, 19)
    times = ([i * 0.5 for i in range(12)] if mode == "speculative"
             else [1.5, 3.5, 5.5])
    queries = [(1.0, "what now?"), (4.0, "and now?")]
    a, b = _pair(cfg, tok, params, {mode: True}, kv_capacity=4096,
                 kv_quant="int8", spec_decode=True)
    ta, tb = _run(a, feats, times, queries), _run(b, feats, times, queries)
    assert ta == tb and len(ta) >= 3
    _assert_same_state(a, b)
    assert a.dispatch_stats()["rolled_back"] >= 1
    assert (a.spec_stats() == b.spec_stats()).all() and a.spec_stats()[0]


# ------------------------------------- fused_respond / multi_respond switches
SWITCH_QUERIES = {"fires": [], "queries": [(0.5, "q1?"), (3.0, "q2?")],
                  "only_queries": [(2.0, "only queries")]}


@pytest.fixture(scope="module")
def switch_refs():
    """The switch cases' blocking runs, one a scenario."""
    return {}


def _switch_case(refs, threshold, name, **switches):
    """The JAX tests' 24-frame stream fed 12 frames at a time (multi-chunk
    bursts) through an engine with ``switches``, beside the engine with
    both off (one run a scenario, shared by the cases through ``refs``)."""
    cfg, tok, params = _setup(threshold, seed=2)
    feats, queries = _feats(cfg, 24, 3), SWITCH_QUERIES[name]
    if (threshold, name) not in refs:
        b = LiveInferEngine(params, tok, cfg, kv_capacity=4096, device="cpu",
                            fused_respond=False, multi_respond=False)
        refs[threshold, name] = b, _run(b, feats, [5.5, 11.5], queries)
    b, tb = refs[threshold, name]
    a = LiveInferEngine(params, tok, cfg, kv_capacity=4096, device="cpu",
                        **switches)
    assert _run(a, feats, [5.5, 11.5], queries) == tb
    assert a.stats()["pending_responses"] == 0
    _assert_same_state(a, b)


@pytest.mark.parametrize("threshold,name", [
    (0.725, "fires"), (0.725, "queries"), (1.1, "only_queries")])
def test_fused_equals_unfused(switch_refs, threshold, name):
    """fused_respond selects the port's step (eager PyTorch has no fused
    program): the same transcripts, offset and prepend."""
    _switch_case(switch_refs, threshold, name, fused_respond=True,
                 multi_respond=False)


@pytest.mark.parametrize("name", ["fires", "queries"])
def test_multi_respond_equals_single(switch_refs, name):
    """multi_respond too: responses that come due together surface one per
    call (none waits in a buffer), with the single-response engine's
    transcripts and state."""
    _switch_case(switch_refs, 0.725, name, fused_respond=True,
                 multi_respond=True)


# ------------------------------------------------------- readbacks in flight
def test_two_dispatches_in_flight_read_their_own_gates():
    """Two speculative dispatches in flight each read back their own gate
    ids (a buffer each), whatever order they are read in: the ids the
    blocking engine reads for the same two frames."""
    cfg, tok, params = _setup(0.725, seed=1, bias=30.0)   # no fire
    feats = _feats(cfg, 2, 7)
    a, b = _pair(cfg, tok, params, dict(speculative=True), kv_capacity=1024)
    seen = []
    settle = b._settle

    def record(e):
        seen.append(e.ids.read().clone())
        return settle(e)

    b._settle = record
    a.load_video(feats)
    a.input_video_stream(0.5)
    a._spec_fill()
    assert a.stats()["inflight_speculative"] == 2
    first, second = a._inflight
    assert first.ids.read().data_ptr() != second.ids.read().data_ptr()
    b.load_video(feats)
    for t in (0.0, 0.5):                    # one frame a call
        b.input_video_stream(t)
        assert b() == (None, None)
    assert len(seen) == 2
    assert torch.equal(second.ids.read(), seen[1])
    assert torch.equal(first.ids.read(), seen[0])
    assert a._host_offset == first.base < a._ring_offset
    assert a.flush() == [] and a._host_offset == b._host_offset


def test_deferred_read_and_to_device_on_the_cpu():
    t = torch.arange(4)
    r = DeferredRead(t)
    t += 1                                  # the read keeps its own copy
    assert torch.equal(r.read(), torch.arange(4)) and r.wait_s == 0.0
    assert to_device(t, "cpu") is t


# ---------------------------------------------------- against the JAX engine
def _jax_port_params(seed, jcfg):
    jparams = jax.device_get(jax_live.init_params(jax.random.PRNGKey(seed),
                                                  jcfg))
    return jparams, params_from_numpy(jparams, device="cpu")


@pytest.mark.parametrize("mode,seed,times,queries,n", [
    ("speculative", 6, [i * 0.5 for i in range(10)],
     [(0.5, "q1?"), (2.0, "q2?")], 10),
    ("pipelined", 9, [1.5, 3.5, 5.5, 7.5], [(0.5, "q1?"), (3.0, "q2?")], 16),
])
def test_dispatch_modes_equal_jax(mode, seed, times, queries, n):
    """The port's driver against the JAX engine's in the same mode (its
    default fused / multi-response programs), on the same weights, with
    gate fires and queries: the same transcripts, byte for byte."""
    (jcfg, jtok), (cfg, tok) = _configs(0.725, 0.0)
    jparams, params = _jax_port_params(seed, jcfg)
    feats = _feats(cfg, n, 11)
    port = LiveInferEngine(params, tok, cfg, kv_capacity=4096, device="cpu",
                           **{mode: True})
    jeng = JaxEngine(jparams, jtok, jcfg, kv_capacity=4096, **{mode: True})
    got = _run(port, feats, times, queries)
    assert got == _run(jeng, feats, times, queries)
    assert len(got) >= 3 and any(q is not None for q, _ in got)
    assert port.dispatch_stats()["rolled_back"] >= 1
    assert port._host_offset == jeng._host_offset


# --------------------------------------------------------- the batched tick
def _ms_drive(ms, feats, queries, schedule):
    """The JAX tests' batched driver: feed per the schedule, tick until
    drained, then the flushed tail and what still surfaces."""
    fps, N = ms.frame_fps, len(feats)
    fed, out, asked = [0] * N, [[] for _ in range(N)], set()
    for t in schedule:
        for i in range(N):
            if i in queries and queries[i][0] <= t and i not in asked:
                ms.input_query(i, queries[i][1], video_time=queries[i][0])
                asked.add(i)
            fidx = min(int(t * fps), feats[i].shape[0] - 1)
            if fidx >= fed[i]:
                ms.input_frames(i, fed[i] / fps, feats[i][fed[i]:fidx + 1])
                fed[i] = fidx + 1
        for _ in range(32):
            results = ms.step()
            for i, res in enumerate(results):
                if res is not None:
                    out[i].append(res)
            if (all(r is None for r in results)
                    and not any(ms.frame_queues)):
                break
    for i, entries in enumerate(ms.flush()):
        out[i].extend(entries)
    for _ in range(32):
        if not ms.pending():
            break
        for i, res in enumerate(ms.step()):
            if res is not None:
                out[i].append(res)
    assert not ms.pending()
    return out


def _ms_state(ms):
    """Host state after a drive: offsets, and each stream's pages with
    their refcounts and the pool's figures (which pool page backs a
    stream's page is the allocator's choice)."""
    state = {"offsets": ms._host_offsets.tolist(),
             "cache_offsets": ms.cache.offset.tolist()}
    assert state["offsets"] == state["cache_offsets"]
    if ms.paged:
        state.update(refs=[[int(ms._page_refs[p]) for p in
                            ms._table_host[i, :ms._pages_alloc[i]]]
                           for i in range(ms.N)],
                     pool=ms.stats()["pool"])
    return state


def _ms_rows(ms):
    """Each stream's K/V rows (codes and scales) up to its offset."""
    pools = [ms.cache.k, ms.cache.v] + (
        [ms.cache.k_scale, ms.cache.v_scale] if ms.cache.quantized else [])
    rows = []
    for i in range(ms.N):
        off = int(ms._host_offsets[i])
        for pool in pools:
            if ms.paged:
                pages = ms._table_host[i, :-(-off // ms.page_size)]
                flat = pool[:, torch.as_tensor(pages, dtype=torch.long)]
                flat = flat.transpose(1, 2).reshape(
                    (pool.shape[0], pool.shape[2], -1) + pool.shape[4:])
                rows.append(flat[:, :, :off])
            else:
                rows.append(pool[:, i, :, :off])
    return rows


def _ms_pair(threshold, seed, **kw):
    cfg, tok, params = _setup(threshold, seed)
    return cfg, [MultiStreamEngine(params, tok, cfg, device="cpu",
                                   pipelined=p, **kw) for p in (True, False)]


def _assert_ms_equal(pipe, ref, out_p, out_r):
    assert out_p == out_r
    assert _ms_state(pipe) == _ms_state(ref)
    for x, y in zip(_ms_rows(pipe), _ms_rows(ref)):
        assert torch.equal(x, y)
    assert pipe.stats()["inflight_dispatches"] == 0


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "ring"])
def test_multistream_pipelined_equals_blocking(paged):
    cfg, (pipe, ref) = _ms_pair(0.725, 4, num_streams=2, kv_capacity=2048,
                                chunk_frames=4, pipeline_depth=2,
                                paged=paged)
    rng = np.random.RandomState(13)
    feats = [rng.randn(16, cfg.frame_num_tokens,
                       cfg.vision_hidden_size).astype(np.float32)
             for _ in range(2)]
    schedule, queries = [0.0, 1.5, 3.0, 5.0, 7.5], {1: (1.6, "status?")}
    out_p = _ms_drive(pipe, feats, queries, schedule)
    _assert_ms_equal(pipe, ref, out_p, _ms_drive(ref, feats, queries,
                                                 schedule))
    st = pipe.dispatch_stats()
    assert st["rolled_back"] >= 1 and st["max_inflight"] == 2


def test_multistream_pipelined_equals_jax():
    """The port's pipelined tick against the JAX engine's (its fused,
    chained ticks), on the same weights, with gate fires, a query and
    rollbacks: the same per-stream results, byte for byte, and the same
    offsets."""
    (jcfg, jtok), (cfg, tok) = _configs(0.725, 0.0)
    jparams, params = _jax_port_params(4, jcfg)
    kw = dict(num_streams=2, kv_capacity=2048, chunk_frames=4,
              pipelined=True, pipeline_depth=2, paged=True)
    port = MultiStreamEngine(params, tok, cfg, device="cpu", **kw)
    jeng = JaxMultiStream(jparams, jtok, jcfg, **kw)
    rng = np.random.RandomState(13)
    feats = [rng.randn(8, cfg.frame_num_tokens,
                       cfg.vision_hidden_size).astype(np.float32)
             for _ in range(2)]
    schedule, queries = [0.0, 1.5, 3.5], {1: (1.6, "status?")}
    got = _ms_drive(port, feats, queries, schedule)
    assert got == _ms_drive(jeng, feats, queries, schedule)
    assert any(q is not None for q, _ in got[1]) and all(got)
    st = port.dispatch_stats()
    assert st["rolled_back"] >= 1 and st["max_inflight"] == 2
    assert port._host_offsets.tolist() == np.asarray(
        jeng._host_offsets).tolist()


def test_multistream_fused_slot_overflow():
    """threshold 1.0 fires the gate at every frame: every tick in flight
    behind a fire rolls back, stream by stream."""
    cfg, (pipe, ref) = _ms_pair(1.0, 5, num_streams=2, kv_capacity=4096,
                                chunk_frames=4)
    rng = np.random.RandomState(17)
    feats = [rng.randn(6, cfg.frame_num_tokens,
                       cfg.vision_hidden_size).astype(np.float32)
             for _ in range(2)]
    out_r = _ms_drive(ref, feats, {}, [0.0, 2.5])
    assert sum(len(o) for o in out_r) >= 2 * 6 - 2      # fires happen
    _assert_ms_equal(pipe, ref, _ms_drive(pipe, feats, {}, [0.0, 2.5]),
                     out_r)


MS_INT8 = dict(num_streams=3, kv_capacity=1024, chunk_frames=4, paged=True,
               page_size=64, pipeline_depth=2, kv_quant="int8")


def test_close_stream_reuses_slot_pipelined():
    """close_stream resolves in-flight ticks, frees the slot's pages and
    serves a new dialogue there: transcripts and state the blocking
    engine's (which tests/test_torch_multistream.py holds to a fresh
    engine's through the JAX engine)."""
    cfg, (pipe, ref) = _ms_pair(0.725, 9, **{**MS_INT8, "num_streams": 2})
    rng = np.random.RandomState(41)
    A, B, C = (rng.randn(8, cfg.frame_num_tokens, cfg.vision_hidden_size)
               .astype(np.float32) for _ in range(3))
    none = np.zeros((0, cfg.frame_num_tokens, cfg.vision_hidden_size),
                    np.float32)
    schedule = [0.0, 1.5, 3.0, 5.0]
    outs = []
    for ms in (pipe, ref):
        out1 = _ms_drive(ms, [A, B], {0: (1.2, "what now?")}, schedule)
        assert len(out1[0]) >= 1 and ms.close_stream(0) == out1[0]
        assert ms._pages_alloc[0] == 0 and ms._pages_alloc[1] > 0
        out2 = _ms_drive(ms, [C, none], {0: (0.9, "anything?")}, schedule)
        assert out2[1] == [] and len(out2[0]) >= 1
        outs.append((out1, out2))
    _assert_ms_equal(pipe, ref, outs[0], outs[1])


def test_fork_stream_branches_dialogue_pipelined():
    """fork_stream after pipelined ticks: shared full pages, a copied tail,
    each branch's transcript the blocking engine's; closing the source
    leaves the fork the sole owner."""
    cfg, (pipe, ref) = _ms_pair(0.725, 9, prefix_cache=False, **MS_INT8)
    rng = np.random.RandomState(43)
    prefix, contA, contB = (rng.randn(n, cfg.frame_num_tokens,
                                      cfg.vision_hidden_size)
                            .astype(np.float32) for n in (8, 6, 6))

    def until_idle(ms):
        for _ in range(96):
            ms.step()
            if not ms.pending():
                return
        raise AssertionError("engine did not drain")

    for ms in (pipe, ref):
        ms.input_frames(0, 0.0, prefix)
        ms.input_query(0, "what now?", video_time=1.2)
        until_idle(ms)
        ms.fork_stream(0, 1)
        shared = int(ms._host_offsets[0]) // ms.page_size
        assert shared >= 1 and np.sum(ms._page_refs == 2) == shared
        ms.input_frames(0, 4.0, contA)
        ms.input_query(0, "continue a?", video_time=4.5)
        ms.input_frames(1, 4.0, contB)
        ms.input_query(1, "continue b?", video_time=4.5)
        until_idle(ms)
        assert ms.transcripts[1] != ms.transcripts[0]
    assert pipe.transcripts == ref.transcripts
    assert _ms_state(pipe) == _ms_state(ref)
    pipe.close_stream(0)
    assert np.sum(pipe._page_refs == 2) == 0 and np.all(pipe._page_refs >= 0)


def test_prefix_cache_admission_matches_prefill_pipelined():
    """Prefix-cache admission under the pipelined tick with the int8 pool:
    the same transcripts as a plain prefill, a hit on re-admission, and the
    pool's accounting exact after forks and closes."""
    cfg, tok, params = _setup(0.725, 9)
    rng = np.random.RandomState(61)
    A, B, C = (rng.randn(8, cfg.frame_num_tokens, cfg.vision_hidden_size)
               .astype(np.float32) for _ in range(3))
    none = np.zeros((0, cfg.frame_num_tokens, cfg.vision_hidden_size),
                    np.float32)
    schedule = [0.0, 1.5, 3.0, 5.0]
    outs = {}
    for pc in (True, False):
        ms = MultiStreamEngine(params, tok, cfg, device="cpu", pipelined=True,
                               prefix_cache=pc, **MS_INT8)
        out1 = _ms_drive(ms, [A, B, none], {0: (1.2, "what now?")}, schedule)
        t0 = ms.close_stream(0)
        out2 = _ms_drive(ms, [C, none, none], {0: (0.9, "anything?")},
                         schedule)
        outs[pc] = (out1, t0, out2)
        assert (ms._prefix_hits >= 1) == pc
        if pc:
            ms.fork_stream(0, 2)
            ms.close_stream(0)
            ms.close_stream(2)
        ms.close_stream(1)
        live_pages = int(np.sum(ms._page_refs > 0))
        assert len(ms._free_pages) == ms.pool_pages - 1 - live_pages
    assert outs[True] == outs[False]
