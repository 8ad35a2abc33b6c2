"""The port's MultiStreamEngine against the JAX MultiStreamEngine.

Same tiny config, the same weights (carried over by ``params_from_numpy``),
the same frames, queries and schedule: per-stream ``step()`` results and
transcripts must be equal byte for byte, and the host state the two
engines expose (offsets, page tables, ``stats()``'s pool figures) equal.
The JAX engine runs its blocking tick (``fused=False``), which its own
tests prove equal to its fused and pipelined ticks; the port runs that
tick whatever ``fused`` says. Each engine pair is built once per module and
driven through a whole scenario in its fixture; the tests read the
recorded checkpoints. On the CPU the port's paged attention is the plain
version of K3 and the JAX package's is its gather reference.
"""

import numpy as np
import pytest
import torch

import jax

from videollm_online_tpu.core.config import tiny_live_config as jax_tiny_cfg
from videollm_online_tpu.models import live as jax_live
from videollm_online_tpu.serve.multistream import (
    MultiStreamEngine as JaxMultiStream)
from videollm_online_tpu.tokenizer.live_tokenizer import (
    LiveTokenizer as JaxTokenizer)
from videollm_online_tpu.tokenizer.tiny import ByteTokenizer as JaxBytes

from videollm_online_tpu_torch.core.config import tiny_live_config
from videollm_online_tpu_torch.models.bridge import params_from_numpy
from videollm_online_tpu_torch.serve.multistream import MultiStreamEngine
from videollm_online_tpu_torch.tokenizer.live_tokenizer import LiveTokenizer
from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs its
    files in parallel processes, where torch's default of a thread a core
    oversubscribes the CPU and its spinning workers slow every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed, jcfg):
    """(jax params, port params): one set of random weights, carried over."""
    jparams = jax.device_get(jax_live.init_params(jax.random.PRNGKey(seed),
                                                  jcfg))
    return jparams, params_from_numpy(jparams, device="cpu")


def _pair(seed, engine_kw, threshold=0.725, max_response_tokens=16):
    """(jax engine, port engine) on one set of random weights."""
    cfgs = []
    for make_cfg, make_tok, bytes_tok in (
            (jax_tiny_cfg, JaxTokenizer, JaxBytes),
            (tiny_live_config, LiveTokenizer, ByteTokenizer)):
        tok = make_tok(bytes_tok(), make_cfg())
        cfg = tok.cfg.replace(frame_token_interval_threshold=threshold,
                              max_response_tokens=max_response_tokens)
        cfgs.append((cfg, tok))
    (jcfg, jtok), (cfg, tok) = cfgs
    jparams, params = _params(seed, jcfg)
    return (JaxMultiStream(jparams, jtok, jcfg, fused=False, **engine_kw),
            MultiStreamEngine(params, tok, cfg, device="cpu", **engine_kw))


def _feats(rng, n, cfg_fnt=10, vh=32):
    return rng.randn(n, cfg_fnt, vh).astype(np.float32)


def _feed_schedule(ms, feats, queries, schedule):
    """Frames up to each schedule time (and the queries due by then), the
    engine drained after each feed; returns the step() results per
    stream. ``queries``: stream -> (video time, text)."""
    fps, N = ms.frame_fps, len(feats)
    fed, asked, out = [0] * N, set(), [[] for _ in range(N)]
    for t in schedule:
        for i in range(N):
            if i in queries and queries[i][0] <= t and i not in asked:
                ms.input_query(i, queries[i][1], video_time=queries[i][0])
                asked.add(i)
            fidx = min(int(t * fps), feats[i].shape[0] - 1)
            if fidx >= fed[i]:
                ms.input_frames(i, fed[i] / fps, feats[i][fed[i]:fidx + 1])
                fed[i] = fidx + 1
        _drain(ms, out)
    return out


def _drain(ms, out, max_ticks=96):
    for _ in range(max_ticks):
        for i, res in enumerate(ms.step()):
            if res is not None:
                out[i].append(res)
        if not ms.pending():
            return out
    raise AssertionError("engine did not drain")


def _snapshot(ms):
    snap = {"transcripts": [list(t) for t in ms.transcripts],
            "offsets": np.asarray(ms._host_offsets).tolist()}
    st = ms.stats()
    snap["streams"] = st["streams"]
    if ms.paged:
        snap["pool"] = st["pool"]
        snap["table"] = np.asarray(ms._table_host).tolist()
        snap["pos_base"] = np.asarray(ms._pos_base_host).tolist()
        snap["refs"] = np.asarray(ms._page_refs).tolist()
        snap["free"] = sorted(ms._free_pages)
    return snap


@pytest.fixture(scope="module")
def ring_run():
    """The batched ring (kv_capacity 512): three streams fed over time with
    a query on stream 1, then slot 0 closed and reused for a new
    dialogue."""
    engines = _pair(0, dict(num_streams=3, kv_capacity=512))
    rng = np.random.RandomState(0)
    feats = [_feats(rng, 4) for _ in range(3)]
    new = [_feats(rng, 4), np.zeros((0, 10, 32), np.float32),
           np.zeros((0, 10, 32), np.float32)]
    rec = {}
    for name, ms in zip(("jax", "port"), engines):
        assert not ms.paged
        out1 = _feed_schedule(ms, feats, {1: (0.9, "what now?")},
                              [0.0, 0.5, 1.0, 1.5])
        snap1 = _snapshot(ms)
        closed = ms.close_stream(0)
        out2 = _feed_schedule(ms, new, {0: (0.9, "anything?")},
                              [0.0, 0.5, 1.0, 1.5])
        rec[name] = dict(out1=out1, snap1=snap1, closed=closed, out2=out2,
                         snap2=_snapshot(ms))
    return rec


@pytest.fixture(scope="module")
def paged_run():
    """The paged pool (page 64, prefix cache on): a catch-up burst with a
    query on streams 0 and 1, slot 0 closed and re-admitted through the
    prefix cache, then stream 1 forked into the idle slot 2 and both
    branches continued."""
    engines = _pair(2, dict(num_streams=3, kv_capacity=1024, chunk_frames=4,
                            paged=True, page_size=64))
    rng = np.random.RandomState(7)
    burst = [_feats(rng, 10), _feats(rng, 10)]
    new, cont_a, cont_b = _feats(rng, 6), _feats(rng, 6), _feats(rng, 6)
    rec = {}
    for name, ms in zip(("jax", "port"), engines):
        assert ms.paged and ms.prefix_cache
        out = [[] for _ in range(3)]
        for i in range(2):
            ms.input_query(i, "what now?", video_time=1.2)
            ms.input_frames(i, 0.0, burst[i])
        r = {"catchup": _drain(ms, out)}
        r["snap_catchup"] = _snapshot(ms)
        r["closed"] = ms.close_stream(0)
        r["snap_closed"] = _snapshot(ms)
        ms.input_frames(0, 0.0, new)
        ms.input_query(0, "anything?", video_time=0.9)
        r["readmit"] = _drain(ms, [[] for _ in range(3)])
        r["snap_readmit"] = _snapshot(ms)
        ms.fork_stream(1, 2)
        r["snap_fork"] = _snapshot(ms)
        for i, cont, q in ((1, cont_a, "continue a?"),
                           (2, cont_b, "continue b?")):
            ms.input_frames(i, 6.0, cont)
            ms.input_query(i, q, video_time=6.5)
        r["branches"] = _drain(ms, [[] for _ in range(3)])
        r["snap_branches"] = _snapshot(ms)
        rec[name] = r
    return rec


@pytest.fixture(scope="module")
def int8_spec_window_run():
    """int8 paged KV with spec decode and a stream window of 256 over pages
    of 64: every stream outgrows the window, so pages are freed."""
    engines = _pair(3, dict(num_streams=2, kv_capacity=640, chunk_frames=4,
                            paged=True, page_size=64, kv_quant="int8",
                            spec_decode=True, stream_window=256))
    rng = np.random.RandomState(31)
    feats = [_feats(rng, 16), _feats(rng, 16)]
    rec = {}
    for name, ms in zip(("jax", "port"), engines):
        assert ms.cache.k.dtype.itemsize == 1
        out = _feed_schedule(ms, feats, {0: (1.2, "what now?")},
                             [0.0, 1.5, 3.0, 5.0, 8.0])
        rec[name] = dict(out=out, snap=_snapshot(ms),
                         spec=np.asarray(ms.spec_stats()).tolist())
    return rec


@pytest.fixture(scope="module")
def ring_window_run():
    """The batched ring at kv_capacity 448 with a stream window of 64: the
    ring compacts (pos_base moves) and transcripts stay equal."""
    engines = _pair(3, dict(num_streams=2, kv_capacity=448, chunk_frames=4,
                            stream_window=64, paged=False),
                    max_response_tokens=12)
    rng = np.random.RandomState(11)
    feats = [_feats(rng, 20), _feats(rng, 20)]
    rec = {}
    for name, ms in zip(("jax", "port"), engines):
        out = [[] for _ in range(2)]
        for i in range(2):
            ms.input_frames(i, 0.0, feats[i])
            ms.input_query(i, "what now?", video_time=1.5)
        rec[name] = dict(out=_drain(ms, out, 256), snap=_snapshot(ms),
                         pos_base=np.asarray(ms.cache.pos_base).tolist())
    return rec


def test_ring_transcripts_equal_jax(ring_run):
    j, p = ring_run["jax"], ring_run["port"]
    assert p["out1"] == j["out1"]
    assert p["snap1"] == j["snap1"]
    assert sum(len(o) for o in j["out1"]) >= 3


def test_ring_close_stream_reuse_equal_jax(ring_run):
    j, p = ring_run["jax"], ring_run["port"]
    assert p["closed"] == j["closed"] == j["snap1"]["transcripts"][0]
    assert p["out2"] == j["out2"]
    assert p["snap2"] == j["snap2"]
    assert len(j["out2"][0]) >= 1 and j["out2"][1] == []


def test_paged_chunked_catchup_with_query_equal_jax(paged_run):
    j, p = paged_run["jax"], paged_run["port"]
    assert p["catchup"] == j["catchup"]
    assert p["snap_catchup"] == j["snap_catchup"]
    assert any(r[0] is not None for r in j["catchup"][0])   # the query
    assert max(j["snap_catchup"]["pool"]["pages_per_stream"]) >= 3


def test_paged_close_stream_and_prefix_admission_equal_jax(paged_run):
    j, p = paged_run["jax"], paged_run["port"]
    assert p["closed"] == j["closed"]
    assert p["snap_closed"] == j["snap_closed"]
    assert p["readmit"] == j["readmit"]
    assert p["snap_readmit"] == j["snap_readmit"]
    pool = j["snap_readmit"]["pool"]
    assert pool["prefix_hits"] >= 1 and pool["prefix_entries"] == 1


def test_paged_fork_stream_equal_jax(paged_run):
    j, p = paged_run["jax"], paged_run["port"]
    assert p["snap_fork"] == j["snap_fork"]
    fork = j["snap_fork"]
    assert fork["table"][2][:fork["offsets"][1] // 64] == \
        fork["table"][1][:fork["offsets"][1] // 64]      # full pages shared
    assert p["branches"] == j["branches"]
    assert p["snap_branches"] == j["snap_branches"]
    assert len(j["branches"][1]) >= 1 and len(j["branches"][2]) >= 1


def test_int8_paged_spec_window_equal_jax(int8_spec_window_run):
    j, p = int8_spec_window_run["jax"], int8_spec_window_run["port"]
    assert p["out"] == j["out"]
    assert p["snap"] == j["snap"]
    assert p["spec"] == j["spec"] and j["spec"][0] > 0
    assert max(j["snap"]["pos_base"]) > 0, "no page was freed"


def test_ring_window_compaction_equal_jax(ring_window_run):
    j, p = ring_window_run["jax"], ring_window_run["port"]
    assert p["out"] == j["out"]
    assert p["snap"] == j["snap"]
    assert p["pos_base"] == j["pos_base"] and max(j["pos_base"]) > 0


def test_refused_options_raise():
    """The pipelined tick builds (tests/test_torch_dispatch.py serves it)
    and excludes segmented responses, as the JAX engine's does; segmented
    responses need a segment length that divides the budget.
    stream_tokens, on_delta and vision_params are carried
    (tests/test_torch_engine_options.py holds them against JAX)."""
    cfg = tiny_live_config()
    tok = LiveTokenizer(ByteTokenizer(), cfg)
    ms = MultiStreamEngine({"llama": {}}, tok, device="cpu", pipelined=True,
                           pipeline_depth=3, num_streams=2, kv_capacity=512)
    assert ms.pipelined and ms.pipeline_depth == 3
    assert ms.stats()["inflight_dispatches"] == 0 and not ms.pending()
    with pytest.raises(ValueError, match="stream_tokens"):
        MultiStreamEngine({"llama": {}}, tok, device="cpu", pipelined=True,
                          stream_tokens=4)
    with pytest.raises(ValueError, match="divide"):
        MultiStreamEngine({"llama": {}}, tok, device="cpu",
                          max_new_tokens=8, stream_tokens=3)
