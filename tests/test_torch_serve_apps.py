"""The port's serving apps against the JAX package's, over real HTTP.

The same tiny fp32 weights (drawn by the port from a seed, handed to the
JAX package as numpy) serve in both packages: ``serve/web.py``'s single-session demo (the transcript over
HTTP equal to the port's engine driven directly and to the JAX web demo's,
token streaming through partial bubbles ending in the same transcript, the
page, the threshold, the 404 and bad-JSON answers) and its multi-session
demo over ``MultiStreamEngine`` (each session's transcript equal to the
engine driven directly and to the JAX demo's, with and without token
streaming; the 409 and 400 answers, ``/stats``, ``/close`` and slot reuse);
``serve/pipeline.py`` (events equal to the sequential drive, in both
packages); ``serve/app.py`` with a fake gradio module (the callbacks drive
the engine as the JAX app's drive the JAX engine); ``serve/tts.py`` (the
same waveforms) and ``serve/rendering.py`` (the same composed pixels, the
same AVI bytes with a TTS track; skipped without PIL). Each JAX engine is
built once for the module.
"""

import contextlib
import json
import sys
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch

from videollm_online_tpu.core.config import tiny_live_config as jax_tiny_cfg
from videollm_online_tpu.serve import app as jax_app
from videollm_online_tpu.serve import tts as jax_tts
from videollm_online_tpu.serve import web as jax_web
from videollm_online_tpu.serve.engine import LiveInferEngine as JaxEngine
from videollm_online_tpu.serve.multistream import (
    MultiStreamEngine as JaxMultiStreamEngine)
from videollm_online_tpu.tokenizer.live_tokenizer import (
    LiveTokenizer as JaxTokenizer)
from videollm_online_tpu.tokenizer.tiny import ByteTokenizer as JaxBytes

from videollm_online_tpu_torch.core.config import tiny_live_config
from videollm_online_tpu_torch.models import live
from videollm_online_tpu_torch.serve import app, tts, web
from videollm_online_tpu_torch.serve.engine import LiveInferEngine
from videollm_online_tpu_torch.serve.multistream import MultiStreamEngine
from videollm_online_tpu_torch.serve.pipeline import StreamingPipeline
from videollm_online_tpu_torch.tokenizer.live_tokenizer import LiveTokenizer
from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer

N_FRAMES, QUERY_AT = 10, 3          # the single-session schedule
MULTI_FRAMES, MULTI_QUERY_AT = 8, 2  # the multi-session schedule


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs its
    files in parallel processes, where torch's default of a thread a core
    oversubscribes the CPU and its spinning workers slow every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """(JAX cfg, tok, params), (port cfg, tok, params): test_web.py's
    configuration, the same weights in both packages."""
    out = []
    for make_cfg, make_tok, bytes_tok in (
            (jax_tiny_cfg, JaxTokenizer, JaxBytes),
            (tiny_live_config, LiveTokenizer, ByteTokenizer)):
        tok = make_tok(bytes_tok(), make_cfg())
        out.append([tok.cfg.replace(frame_token_interval_threshold=0.725,
                                    max_response_tokens=16), tok])
    params = live.init_params(torch.Generator().manual_seed(0), out[1][0],
                              device="cpu")
    out[0].append(_numpy_tree(params))
    out[1].append(params)
    return out


def _numpy_tree(tree):
    """The port's parameter tree as the JAX package's numpy tree (the same
    keys and leaves)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


def _req(base, path, payload=None):
    if payload is None:
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return json.loads(r.read())
    req = urllib.request.Request(base + path,
                                 data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


@contextlib.contextmanager
def _running(httpd):
    """The server's base URL while it serves on a thread."""
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
        assert not t.is_alive()


def _pairs(msgs):
    return [(m["role"], m["text"]) for m in msgs]


def _times(cfg, n):
    return [i / cfg.frame_fps for i in range(n)]


def _feats(cfg, n, seed):
    """The features WebDemo.load draws for {"frames": n, "seed": seed}."""
    return np.random.RandomState(seed).randn(
        n, cfg.frame_num_tokens, cfg.vision_hidden_size).astype(np.float32)


def _web_single(base, cfg):
    """test_web.py's single-session schedule over HTTP."""
    times = _times(cfg, N_FRAMES)
    assert _req(base, "/load", {"frames": N_FRAMES, "seed": 7})["ok"]
    for t in times:
        if t == times[QUERY_AT]:
            _req(base, "/query", {"text": "what now?", "time": t})
        _req(base, f"/step?time={t}")
    return _pairs(_req(base, "/history")["messages"])


def _direct_single(engine, cfg):
    """The same schedule on the engine itself."""
    times = _times(cfg, N_FRAMES)
    engine.reset()
    engine.load_video(_feats(cfg, N_FRAMES, 7))
    out = []
    for t in times:
        if t == times[QUERY_AT]:
            engine.input_query_stream("what now?", video_time=t)
        engine.input_video_stream(t)
        while True:
            q, r = engine()
            if r is None:
                break
            if q:
                out.append(("user", q))
            out.append(("assistant", r))
    return out


def _sequential(engine, cfg, n=6):
    """test_pipeline.py's sequential reference: (query, response) events."""
    engine.reset()
    engine.load_video(_feats(cfg, n, 0))
    events, t = [], 0.0
    while t <= (n - 1) / cfg.frame_fps:
        engine.input_video_stream(t)
        while True:
            q, r = engine()
            if r is None:
                break
            events.append((q, r))
        t += 1.0 / cfg.frame_fps
    return events


def _web_multi(base, cfg, demo, drain_rounds=8):
    """test_web.py's multi-session schedule over HTTP: sessions a and b,
    the refusals, a query on a, every frame stepped, the queue drained;
    then /stats, /close of a and c on the freed slot. Returns (a's and b's
    transcripts, a's closed transcript, the partial flag, the stats)."""
    times = _times(cfg, MULTI_FRAMES)
    assert _req(base, "/load", {"sid": "a", "frames": MULTI_FRAMES,
                                "seed": 7}) == {"ok": True, "slot": 0}
    assert _req(base, "/load", {"sid": "b", "frames": MULTI_FRAMES,
                                "seed": 9}) == {"ok": True, "slot": 1}
    for payload, code in (({"sid": "c", "frames": 4}, 409),
                          ({"frames": 4}, 400)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(base, "/load", payload)
        assert e.value.code == code
    with pytest.raises(urllib.error.HTTPError) as e:
        _req(base, "/step?sid=nobody&time=0")
    assert e.value.code == 400
    _req(base, "/query", {"sid": "a", "text": "what now?",
                          "time": times[MULTI_QUERY_AT]})
    partial = False
    for t in times:
        ma = _req(base, f"/step?sid=a&time={t}")["messages"]
        mb = _req(base, f"/step?sid=b&time={t}")["messages"]
        partial |= any(m.get("partial") for m in ma + mb)
    for _ in range(drain_rounds):
        ma = _req(base, f"/step?sid=a&time={times[-1]}")["messages"]
        mb = _req(base, f"/step?sid=b&time={times[-1]}")["messages"]
        partial |= any(m.get("partial") for m in ma + mb)
        if (not demo.ms.pending()
                and not any(m.get("partial") for m in ma + mb)):
            break
    stats = _req(base, "/stats")
    closed = _req(base, "/close", {"sid": "a"})["messages"]
    assert closed == ma
    assert _req(base, "/load", {"sid": "c", "frames": 4,
                                "seed": 3})["slot"] == 0
    _req(base, "/step?sid=c&time=0.0")
    assert _req(base, "/stats")["sessions"] == {"b": 1, "c": 0}
    return _pairs(ma), _pairs(mb), partial, stats


def _direct_multi(ms, cfg, drain_rounds=8):
    """The multi-session schedule on the engine itself: each poll feeds
    the polling session's frames up to its clock, then one tick, every
    stream's surfaced responses collected."""
    times = _times(cfg, MULTI_FRAMES)
    feats = {0: _feats(cfg, MULTI_FRAMES, 7), 1: _feats(cfg, MULTI_FRAMES, 9)}
    fed, msgs = {0: 0, 1: 0}, {0: [], 1: []}

    def poll(slot, t):
        fidx = min(int(t * cfg.frame_fps), MULTI_FRAMES - 1)
        if fidx >= fed[slot]:
            ms.input_frames(slot, fed[slot] / cfg.frame_fps,
                            feats[slot][fed[slot]:fidx + 1])
            fed[slot] = fidx + 1
        for i, r in enumerate(ms.step()):
            if r is not None:
                if r[0]:
                    msgs[i].append(("user", r[0]))
                msgs[i].append(("assistant", r[1]))

    ms.input_query(0, "what now?", video_time=times[MULTI_QUERY_AT])
    for t in times:
        poll(0, t)
        poll(1, t)
    for _ in range(drain_rounds):
        poll(0, times[-1])
        poll(1, times[-1])
        if not ms.pending():
            break
    return msgs[0], msgs[1]


@pytest.fixture(scope="module")
def jax_runs(setup):
    """The JAX package's transcripts, each JAX engine built once: the web
    demo single and multi, the sequential pipeline reference and the gradio
    app's chat."""
    (jcfg, jtok, jparams), _ = setup
    engine = JaxEngine(jparams, jtok, jcfg, kv_capacity=1024,
                       fused_respond=False, multi_respond=False)
    httpd, _ = jax_web.serve(engine, jcfg.frame_fps, port=0)
    with _running(httpd) as base:
        single = _web_single(base, jcfg)
    ms = JaxMultiStreamEngine(jparams, jtok, jcfg, num_streams=2,
                              kv_capacity=2048, chunk_frames=4, fused=False)
    httpd, demo = jax_web.serve_multi(ms, jcfg.frame_fps, port=0)
    with _running(httpd) as base:
        multi = _web_multi(base, jcfg, demo)
    events = _sequential(engine, jcfg)
    chat = _app_chat(jax_app, engine)
    return {"single": single, "multi": multi[:2], "events": events,
            "chat": chat}


@pytest.fixture()
def engine(setup):
    _, (cfg, tok, params) = setup
    return LiveInferEngine(params, tok, cfg, kv_capacity=1024, device="cpu")


# ---------------------------------------------------------------- web demo

def test_web_demo_equals_direct_engine_and_jax(setup, engine, jax_runs):
    _, (cfg, tok, params) = setup
    httpd, demo = web.serve(engine, cfg.frame_fps, port=0)
    with _running(httpd) as base:
        got = _web_single(base, cfg)
    direct = _direct_single(
        LiveInferEngine(params, tok, cfg, kv_capacity=1024, device="cpu"),
        cfg)
    assert got == direct == jax_runs["single"]
    assert any(r == "user" for r, _ in got) and len(got) > 1


def test_web_demo_page_threshold_and_errors(setup, engine):
    _, (cfg, _, _) = setup
    httpd, demo = web.serve(engine, cfg.frame_fps, port=0)
    with _running(httpd) as base:
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            page = r.read().decode()
        assert page == jax_web.PAGE.replace("__THRESHOLD__", "0.725") \
            .replace("__POLL_MS__", "250")
        assert web.PAGE == jax_web.PAGE
        assert _req(base, "/step?time=0.0") == {"messages": [], "time": 0.0}
        _req(base, "/load", {"frames": 4})
        out = _req(base, "/step?time=0.0&threshold=0.9")
        assert isinstance(out["messages"], list) and out["time"] == 0.0
        assert engine.cfg.frame_token_interval_threshold == 0.9
        assert isinstance(_req(base, "/step?time=0.5")["messages"], list)
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(base, "/nope")
        assert e.value.code == 404
        req = urllib.request.Request(base + "/load", data=b"{bad",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 400


def test_web_demo_token_streaming(setup, jax_runs):
    """With stream_tokens the demo ticks on a worker thread and a partial
    assistant bubble grows through on_delta; the transcript it ends with
    is the blocking one. Each step waits for its tick, so no tick is
    coalesced with the next."""
    _, (cfg, tok, params) = setup
    eng = LiveInferEngine(params, tok, cfg, kv_capacity=1024,
                          stream_tokens=4, device="cpu")
    demo = web.WebDemo(eng, cfg.frame_fps)
    assert demo._streaming and eng.on_delta == demo._on_delta
    partial = []

    def on_delta(delta, done):
        demo._on_delta(delta, done)
        partial.extend(m["text"] for m in demo.snapshot() if m.get("partial"))
    eng.on_delta = on_delta
    ticks = threading.Semaphore(0)
    advance = demo._advance

    def counted(*a):
        try:
            advance(*a)
        finally:
            ticks.release()
    demo._advance = counted
    demo.load({"frames": N_FRAMES, "seed": 7})
    times = _times(cfg, N_FRAMES)
    for t in times:
        if t == times[QUERY_AT]:
            demo.query("what now?", t)
        demo.step(t)
        assert ticks.acquire(timeout=60)
    assert _pairs(demo.snapshot()) == jax_runs["single"]
    assert partial and all(partial), "no partial bubble surfaced"


def test_multi_session_web_equals_direct_and_jax(setup, jax_runs):
    _, (cfg, tok, params) = setup
    results = {}
    for S in (None, 4):
        ms = MultiStreamEngine(params, tok, cfg, num_streams=2,
                               kv_capacity=2048, chunk_frames=4,
                               stream_tokens=S, device="cpu")
        httpd, demo = web.serve_multi(ms, cfg.frame_fps, port=0)
        with _running(httpd) as base:
            results[S] = _web_multi(base, cfg, demo, drain_rounds=48)
        if S is None:
            assert results[S][3]["sessions"] == {"a": 0, "b": 1}
            assert len(results[S][3]["streams"]) == 2
    direct = _direct_multi(MultiStreamEngine(
        params, tok, cfg, num_streams=2, kv_capacity=2048, chunk_frames=4,
        device="cpu"), cfg)
    ma, mb = results[None][:2]
    assert (ma, mb) == direct == jax_runs["multi"]
    assert results[4][:2] == (ma, mb)
    assert results[4][2], "no partial bubble surfaced over HTTP"
    assert any(r == "user" and "what now?" in t for r, t in ma)
    assert not any(r == "user" for r, _ in mb) and ma != mb


def test_web_main_refuses_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    for argv in ([], ["--multi", "2"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            web.main(argv)


def test_web_main_builds_on_the_cpu_when_asked(monkeypatch):
    """``--device cpu`` builds through the cli's builders (the single
    engine, and with --multi the batched one) and serves them."""
    served = []

    class _Server:
        def serve_forever(self):
            served.append(True)
    for name in ("serve", "serve_multi"):
        monkeypatch.setattr(web, name, lambda eng, fps, port=0, name=name: (
            served.append((name, eng, port)) or (_Server(), None)))
    web.main(["--device", "cpu", "--port", "0", "--stream_tokens", "4"])
    web.main(["--device", "cpu", "--port", "0", "--multi", "2"])
    (n1, e1, _), _, (n2, e2, _), _ = served
    assert n1 == "serve" and isinstance(e1, LiveInferEngine)
    assert e1.stream_tokens == 4 and e1.on_delta is None
    assert e1.device.type == "cpu"
    assert n2 == "serve_multi" and isinstance(e2, MultiStreamEngine)
    assert e2.N == 2 and e2.device.type == "cpu"


# ---------------------------------------------------------------- pipeline

def test_pipeline_equals_sequential_and_jax(setup, jax_runs):
    _, (cfg, tok, params) = setup
    seq = _sequential(
        LiveInferEngine(params, tok, cfg, kv_capacity=512, device="cpu"), cfg)
    eng = LiveInferEngine(params, tok, cfg, kv_capacity=512, device="cpu")
    eng.load_video(_feats(cfg, 6, 0))
    pipe = StreamingPipeline(eng, realtime=False)
    pipe.start_video(5 / cfg.frame_fps)
    events = pipe.drain()
    pipe.stop()
    assert not pipe._producer.is_alive()
    assert events == seq == jax_runs["events"] and len(events) >= 1


# ---------------------------------------------------------------- gradio app

_REGISTRY = []


class _Component:
    def __init__(self, *a, **kw):
        self.kw = kw
        self.handlers = {}
        _REGISTRY.append(self)

    def change(self, fn, inputs, outputs):
        self.handlers["change"] = fn

    def submit(self, fn, inputs, outputs):
        self.handlers["submit"] = fn


class _Blocks(_Component):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.load_calls = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def load(self, fn, inputs, outputs, js=None, every=None):
        self.load_calls.append({"js": js, "every": every})


def _fake_gradio():
    gr = types.ModuleType("gradio")
    gr.Blocks = gr.Row = gr.Column = _Blocks
    for name in ("Video", "Slider", "Number", "Chatbot", "Textbox",
                 "Markdown"):
        setattr(gr, name, _Component)
    return gr


def _app_chat(module, engine):
    """test_app.py's flow through ``module.build_app`` with a fake gradio:
    the wiring's callbacks drive ``engine``; returns the chat history."""
    saved = sys.modules.get("gradio")
    sys.modules["gradio"] = _fake_gradio()
    _REGISTRY.clear()
    try:
        engine.reset()
        engine.load_video(_feats(engine.cfg, 8, 0))
        built = module.build_app(engine, frame_fps=engine.frame_fps,
                                 resolution=engine.cfg.frame_resolution)
        assert built.load_calls[0]["every"] == pytest.approx(
            0.5 / engine.frame_fps)
        assert "currentTime" in built.load_calls[0]["js"]
        on_time = next(c.handlers["change"] for c in _REGISTRY
                       if "change" in c.handlers
                       and c.kw.get("visible") is False)
        on_query = next(c.handlers["submit"] for c in _REGISTRY
                        if "submit" in c.handlers)
        on_video = next(c.handlers["change"] for c in _REGISTRY
                        if "change" in c.handlers
                        and c.kw.get("elem_id") == "gr_video")
        assert on_video(None) == []
        assert on_query("what is happening?") == ""
        history = []
        for i in range(1, 9):
            history = on_time(i / engine.frame_fps, 0.725)
        return list(history)
    finally:
        if saved is None:
            sys.modules.pop("gradio", None)
        else:
            sys.modules["gradio"] = saved


def test_app_wiring_drives_engine_as_jax(engine, jax_runs):
    chat = _app_chat(app, engine)
    assert chat == jax_runs["chat"]
    assert any(r is not None for _, r in chat)
    assert any(q is not None for q, _ in chat)
    assert engine.cfg.frame_token_interval_threshold == 0.725


def test_app_without_gradio_raises(engine, monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(RuntimeError, match="gradio is not installed"):
        app.build_app(engine, 2.0, 384)


# ------------------------------------------------------ TTS and rendering

@pytest.mark.parametrize("seed", [2, 5])
def test_tts_equals_jax(seed):
    for text in ("Hello there, I can see you cooking.", "Hi.", "",
                 "Pour the water, then stir!"):
        sr, wave = tts.FormantTTS(seed)(text)
        jsr, jwave = jax_tts.FormantTTS(seed)(text)
        assert sr == jsr == tts.SAMPLE_RATE
        assert wave.dtype == np.float32
        np.testing.assert_array_equal(wave, jwave)
    np.testing.assert_array_equal(tts.default_tts_fn()("ok")[1],
                                  jax_tts.default_tts_fn()("ok")[1])


_CONVERSATION = [
    {"role": "user", "content": "what now?", "time": 0.5},
    {"role": "assistant", "content": "You wash the pan with the sponge, "
     "then you rinse it under the tap.", "time": 1.0},
    {"role": "assistant", "content": "You dry it.", "time": 2.5}]


def test_compose_frame_equals_jax():
    pytest.importorskip("PIL")
    from videollm_online_tpu.serve.rendering import (
        compose_frame as jax_compose)
    from videollm_online_tpu_torch.serve.rendering import compose_frame
    frame = np.random.RandomState(0).randint(0, 255, (3, 128, 160), np.uint8)
    for msgs in ([], _CONVERSATION, _CONVERSATION * 4):
        got = compose_frame(frame, msgs)
        assert got.shape == (128, 160 + 512, 3)
        np.testing.assert_array_equal(got, jax_compose(frame, msgs))


def test_render_with_tts_avi_bytes_equal_jax(tmp_path, monkeypatch):
    """The first-party mux (no ffmpeg): the same MJPEG AVI with the same
    PCM track, byte for byte; then the same from a cli history."""
    pytest.importorskip("PIL")
    from videollm_online_tpu.data import video_io as jax_video_io
    from videollm_online_tpu.serve import rendering as jax_rendering
    from videollm_online_tpu_torch.data import avi, video_io
    from videollm_online_tpu_torch.serve import rendering
    for mod in (video_io, jax_video_io):
        monkeypatch.setattr(mod, "_FFMPEG", "")
    video = np.random.RandomState(1).randint(0, 255, (8, 3, 48, 64),
                                             np.uint8)
    outs = []
    for name, mod, tts_mod in (("mine", rendering, tts),
                               ("theirs", jax_rendering, jax_tts)):
        out = mod.render_conversation_video(
            video, _CONVERSATION, str(tmp_path / f"{name}.mp4"), fps=2,
            tts_fn=tts_mod.default_tts_fn())
        assert out.endswith(".avi")
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]
    data = avi.read_avi(str(tmp_path / "mine.avi"), with_audio=True)
    assert data.frames.shape == (8, 48, 64 + 512, 3)
    assert data.sample_rate == 16000
    assert np.abs(data.audio[:int(0.9 * 16000)]).max() == 0
    assert np.abs(data.audio[16000:32000]).max() > 1000
    history = {"messages": [
        {"role": "user", "content": "(Video Time = 0.5s) what now?"},
        {"role": "assistant", "content": "(Video Time = 1.0s) Assistant: "
         "You wash the pan."}]}
    hist = str(tmp_path / "history.json")
    with open(hist, "w") as f:
        json.dump(history, f)
    outs = [open(mod.render_from_history(hist, video, str(tmp_path / name)
                                         + ".avi"), "rb").read()
            for name, mod in (("h_mine", rendering),
                              ("h_theirs", jax_rendering))]
    assert outs[0] == outs[1]
