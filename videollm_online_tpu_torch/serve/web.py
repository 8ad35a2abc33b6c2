"""Dependency-free web demo: stdlib HTTP server + polling JS front-end.

Counterpart of ``videollm_online_tpu/serve/web.py``: the same endpoints,
JSON and page, over the port's engines (``LiveInferEngine``, and with
``--multi N`` the batched ``MultiStreamEngine``), which run on the card
unless ``--device cpu`` asks for the CPU.

Parity target: the reference's gradio demo (demo/app.py — video element
polled at wall-clock rate driving ``input_video_stream``, a chat box feeding
``input_query_stream``, a threshold slider, demo/app.py:54-57). serve/app.py
keeps the gradio construction for environments that have gradio; THIS module
serves the identical interaction loop with zero dependencies (http.server +
vanilla JS), so the web surface runs — and is testable end-to-end — in any
image the framework itself runs in.

Endpoints (all JSON):
  GET  /            the single-page UI
  POST /load        {"frames": N} synthetic demo stream, or {"path": ...}
                    anything engine.load_video accepts
  POST /query       {"text": str, "time": float} -> queued query
  GET  /step        ?time=T[&threshold=X] -> advance the stream clock to T,
                    drain the engine, return {"messages": [...], "time": T}
  GET  /history     full transcript so far

Engine calls are serialized with a lock (the engine is single-threaded
state; the reference's gradio queue gives the same discipline).

Run:  python -m videollm_online_tpu_torch.serve.web --model_size tiny --port 8600
      [--device cpu] [--multi N] [--stream_tokens S] [--kv_quant int8]
"""

from __future__ import annotations

import argparse
import json
import threading
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>videollm-online-tpu</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 2rem; max-width: 60rem; }
 #chat { border: 1px solid #ccc; border-radius: 6px; padding: 1rem;
         height: 20rem; overflow-y: auto; background: #fafafa; }
 .user { color: #0b5394; margin: .3rem 0; }
 .assistant { color: #222; margin: .3rem 0 .8rem; }
 .meta { color: #888; font-size: .85em; }
 input[type=text] { width: 70%; padding: .4rem; }
 button { padding: .4rem .8rem; }
 .row { margin: .8rem 0; }
</style></head><body>
<h2>VideoLLM-online (TPU) — streaming video dialogue</h2>
<div class="row">
  <button id="start">Start demo stream</button>
  <label> threshold <input id="thr" type="range" min="0" max="1"
      step="0.005" value="__THRESHOLD__">
      <span id="thrv">__THRESHOLD__</span></label>
  <span class="meta">video time: <span id="clock">0.0</span>s</span>
</div>
<div id="chat"></div>
<div class="row">
  <input id="query" type="text" placeholder="ask anything (streamed)">
  <button id="send">Send</button>
</div>
<script>
const chat = document.getElementById("chat");
let t0 = null, timer = null, shown = 0;
function render(msgs) {
  for (; shown < msgs.length; shown++) {
    const m = msgs[shown];
    const div = document.createElement("div");
    div.className = m.role;
    div.textContent = (m.role === "user" ? "You: " : "Assistant: ") + m.text;
    chat.appendChild(div);
  }
  // refresh the last bubble too: token-streaming grows it between polls
  const nodes = chat.children;
  for (let i = Math.max(0, msgs.length - 2); i < msgs.length; i++) {
    const m = msgs[i];
    nodes[i].className = m.role;
    nodes[i].textContent =
      (m.role === "user" ? "You: " : "Assistant: ") + m.text +
      (m.partial ? " ▌" : "");
  }
  chat.scrollTop = chat.scrollHeight;
}
async function step() {
  const t = (Date.now() - t0) / 1000;
  document.getElementById("clock").textContent = t.toFixed(1);
  const thr = document.getElementById("thr").value;
  document.getElementById("thrv").textContent = thr;
  const r = await fetch(`/step?time=${t}&threshold=${thr}`);
  render((await r.json()).messages);
}
document.getElementById("start").onclick = async () => {
  await fetch("/load", {method: "POST", body: JSON.stringify({frames: 600})});
  chat.innerHTML = ""; shown = 0; t0 = Date.now();
  if (timer) clearInterval(timer);
  timer = setInterval(step, __POLL_MS__);
};
document.getElementById("send").onclick = async () => {
  const q = document.getElementById("query");
  const t = t0 ? (Date.now() - t0) / 1000 : 0;
  await fetch("/query", {method: "POST",
                         body: JSON.stringify({text: q.value, time: t})});
  q.value = "";
};
</script></body></html>
"""


class WebDemo:
    """Engine-facing state shared by the handler threads.

    With a token-streaming engine (``stream_tokens=S``, serve/engine.py) the
    demo turns ASYNC: ``step`` hands the tick to a worker thread and returns
    the current transcript immediately, while the engine's ``on_delta``
    grows a ``{"partial": true}`` assistant bubble that successive polls
    watch fill in — the UI shows text as it decodes instead of waiting for
    the full response (the reference's gradio app waits for whole turns,
    demo/app.py:85-91)."""

    def __init__(self, engine, frame_fps: float):
        self.engine = engine
        self.frame_fps = frame_fps
        self.lock = threading.Lock()
        self.messages: List[Dict[str, Any]] = []
        self._loaded = False
        self._msg_lock = threading.Lock()
        self._partial_msg: Optional[Dict[str, Any]] = None
        self._streaming = bool(getattr(engine, "stream_tokens", None))
        if self._streaming and getattr(engine, "on_delta", None) is None:
            engine.on_delta = self._on_delta
        self._pending: Optional[tuple] = None
        self._tick = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._worker_error: Optional[BaseException] = None

    def _on_delta(self, delta: str, done: bool) -> None:
        with self._msg_lock:
            if self._partial_msg is None:
                self._partial_msg = {"role": "assistant", "text": "",
                                     "partial": True}
                self.messages.append(self._partial_msg)
            self._partial_msg["text"] += delta
            if done:
                self._partial_msg["partial"] = False
                # keep the ref: _drain replaces the raw text with the
                # formatted transcript and inserts the user line before it

    # each op mirrors one gradio callback in serve/app.py
    def load(self, spec: Dict[str, Any]) -> None:
        with self.lock:
            self.engine.reset()
            if "path" in spec:
                self.engine.load_video(spec["path"])
            else:
                n = int(spec.get("frames", 600))
                cfg = self.engine.cfg
                rng = np.random.RandomState(int(spec.get("seed", 0)))
                feats = rng.randn(n, cfg.frame_num_tokens,
                                  cfg.vision_hidden_size).astype(np.float32)
                self.engine.load_video(feats)
            with self._msg_lock:
                self.messages = []
                self._partial_msg = None
            self._loaded = True

    def snapshot(self) -> List[Dict[str, Any]]:
        """Race-free copy for the JSON handlers (the streaming worker may
        be growing a partial bubble concurrently)."""
        with self._msg_lock:
            return [dict(m) for m in self.messages]

    def query(self, text: str, video_time: float) -> None:
        with self.lock:
            self.engine.input_query_stream(text, video_time=video_time)

    def step(self, video_time: float,
             threshold: Optional[float] = None) -> List[Dict[str, Any]]:
        if self._streaming:
            # async: queue the newest tick for the worker, snapshot now
            if self._worker_error is not None:
                err, self._worker_error = self._worker_error, None
                raise err
            with self._tick:
                self._pending = (video_time, threshold)
                if self._worker is None or not self._worker.is_alive():
                    self._worker = threading.Thread(target=self._worker_loop,
                                                    daemon=True)
                    self._worker.start()
                self._tick.notify()
            with self._msg_lock:
                return [dict(m) for m in self.messages]
        with self.lock:
            if not self._loaded:
                return self.messages
            self._advance(video_time, threshold)
            return self.messages

    def _advance(self, video_time: float, threshold: Optional[float]) -> None:
        """Run one stream tick + drain (caller holds self.lock)."""
        if threshold is not None:
            self.engine.set_threshold(threshold)
        self.engine.input_video_stream(video_time)
        while True:
            q, r = self.engine()
            if r is None:
                break
            with self._msg_lock:
                part, self._partial_msg = self._partial_msg, None
                if part is not None:
                    # streamed: the bubble already holds the raw text —
                    # swap in the formatted transcript, user line before it
                    if q:
                        self.messages.insert(
                            self.messages.index(part),
                            {"role": "user", "text": q, "time": video_time})
                    part["text"] = r
                    part["time"] = video_time
                    part.pop("partial", None)
                else:
                    if q:
                        self.messages.append({"role": "user", "text": q,
                                              "time": video_time})
                    self.messages.append({"role": "assistant", "text": r,
                                          "time": video_time})

    def _worker_loop(self) -> None:
        while True:
            with self._tick:
                if self._pending is None and not self._tick.wait(timeout=10):
                    return  # idle; the next step() starts a fresh worker
                if self._pending is None:
                    continue
                video_time, threshold = self._pending
                self._pending = None
            try:
                with self.lock:
                    if self._loaded:
                        self._advance(video_time, threshold)
            except BaseException as e:  # surfaced by the next step()
                self._worker_error = e
                return


def make_handler(demo: WebDemo, poll_ms: int):
    thr0 = demo.engine.cfg.frame_token_interval_threshold

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet test runs
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                page = (PAGE.replace("__THRESHOLD__", f"{thr0:g}")
                        .replace("__POLL_MS__", str(poll_ms)))
                body = page.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif url.path == "/step":
                qs = parse_qs(url.query)
                t = float(qs.get("time", ["0"])[0])
                thr = qs.get("threshold")
                msgs = demo.step(t, float(thr[0]) if thr else None)
                self._json({"messages": msgs, "time": t})
            elif url.path == "/history":
                self._json({"messages": demo.snapshot()})
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                return self._json({"error": "bad json"}, 400)
            if self.path == "/load":
                demo.load(payload)
                self._json({"ok": True})
            elif self.path == "/query":
                demo.query(str(payload.get("text", "")),
                           float(payload.get("time", 0.0)))
                self._json({"ok": True})
            else:
                self._json({"error": "not found"}, 404)

    return Handler


def serve(engine, frame_fps: float, port: int = 8600, poll_ms: int = 0):
    """Build the server (port 0 = ephemeral). Caller starts/stops it."""
    demo = WebDemo(engine, frame_fps)
    poll_ms = poll_ms or max(int(1000 * 0.5 / frame_fps), 50)
    httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                make_handler(demo, poll_ms))
    return httpd, demo


class SlotsFull(RuntimeError):
    """All stream slots are occupied (HTTP 409)."""


class MultiWebDemo:
    """Multi-session serving over ONE MultiStreamEngine: each browser
    session (``sid``) occupies a stream slot; all sessions share the
    batched device programs. Slot lifecycle is the engine's continuous
    batching — re-/load closes the session's prior dialogue
    (``close_stream``) and /close frees the slot for the next visitor.
    The reference can serve exactly one gradio session per process."""

    def __init__(self, ms, frame_fps: float):
        self.ms = ms
        self.frame_fps = frame_fps
        self.lock = threading.Lock()
        self.sessions: Dict[str, int] = {}
        self._feats: Dict[int, np.ndarray] = {}
        self._fed: Dict[int, int] = {}
        self.messages: Dict[int, List[Dict[str, Any]]] = {}
        # token-streaming engine (stream_tokens=S): per-slot partial
        # bubbles grow from the engine's on_delta(slot, delta, done) while
        # segments decode; the completed response's formatted entry swaps
        # into its bubble when it surfaces (same contract as WebDemo, per
        # slot). on_delta fires inside ms.step()/close_stream(), both of
        # which run under self.lock — no extra locking needed.
        self._partial: Dict[int, Optional[Dict[str, Any]]] = {}
        self._done_bubbles: Dict[int, deque] = {}
        self._streaming = bool(getattr(ms, "stream_tokens", None))
        if self._streaming and getattr(ms, "on_delta", None) is None:
            ms.on_delta = self._on_delta

    def _on_delta(self, slot: int, delta: str, done: bool) -> None:
        msgs = self.messages.setdefault(slot, [])
        part = self._partial.get(slot)
        if part is None:
            part = {"role": "assistant", "text": "", "partial": True}
            self._partial[slot] = part
            msgs.append(part)
        part["text"] += delta
        if done:
            part["partial"] = False
            self._partial[slot] = None
            # FIFO per slot: a stream has one open response at a time, so
            # this bubble pairs with the slot's NEXT surfaced entry
            self._done_bubbles.setdefault(slot, deque()).append(part)

    def load(self, sid: str, spec: Dict[str, Any]) -> int:
        with self.lock:
            if sid in self.sessions:
                slot = self.sessions[sid]
                self.ms.close_stream(slot)  # drains any open response
                self._partial.pop(slot, None)
                self._done_bubbles.pop(slot, None)
            else:
                used = set(self.sessions.values())
                free = [i for i in range(self.ms.N) if i not in used]
                if not free:
                    raise SlotsFull("no free session slots")
                slot = free[0]
                self.sessions[sid] = slot
            n = int(spec.get("frames", 600))
            cfg = self.ms.cfg
            rng = np.random.RandomState(int(spec.get("seed", 0)))
            self._feats[slot] = rng.randn(
                n, cfg.frame_num_tokens,
                cfg.vision_hidden_size).astype(np.float32)
            self._fed[slot] = 0
            self.messages[slot] = []
            return slot

    def query(self, sid: str, text: str, video_time: float) -> None:
        with self.lock:
            self.ms.input_query(self.sessions[sid], text,
                                video_time=video_time)

    def step(self, sid: str, video_time: float) -> List[Dict[str, Any]]:
        """Advance THIS session's stream clock, tick the shared engine
        once, and drain every session's surfaced responses (a slow
        session's responses surface on whichever session polls next —
        same discipline as the engine's own FIFO)."""
        with self.lock:
            slot = self.sessions[sid]
            feats = self._feats.get(slot)
            if feats is not None and len(feats):
                fidx = min(int(video_time * self.frame_fps), len(feats) - 1)
                if fidx >= self._fed[slot]:
                    self.ms.input_frames(slot, self._fed[slot] / self.frame_fps,
                                         feats[self._fed[slot]:fidx + 1])
                    self._fed[slot] = fidx + 1
            results = self.ms.step()
            for i, r in enumerate(results):
                if r is None:
                    continue
                q, resp = r
                msgs = self.messages.setdefault(i, [])
                dq = self._done_bubbles.get(i)
                part = dq.popleft() if dq else None
                if part is not None:
                    # streamed: the bubble already holds the raw text —
                    # swap in the formatted entry, user line before it
                    if q:
                        msgs.insert(msgs.index(part),
                                    {"role": "user", "text": q,
                                     "time": video_time})
                    part["text"] = resp
                    part["time"] = video_time
                    part.pop("partial", None)
                    continue
                if q:
                    msgs.append({"role": "user", "text": q,
                                 "time": video_time})
                msgs.append({"role": "assistant", "text": resp,
                             "time": video_time})
            # snapshot: other sessions' polls mutate these dicts (partial
            # bubbles grow) while the handler serializes
            return [dict(m) for m in self.messages.get(slot, [])]

    def close(self, sid: str) -> List[Dict[str, Any]]:
        with self.lock:
            slot = self.sessions.pop(sid)
            self.ms.close_stream(slot)  # drains any open response
            self._partial.pop(slot, None)
            self._done_bubbles.pop(slot, None)
            self._feats.pop(slot, None)
            self._fed.pop(slot, None)
            return self.messages.pop(slot, [])

    def stats(self) -> Dict[str, Any]:
        with self.lock:
            st = self.ms.stats()
            st["sessions"] = dict(self.sessions)
            return st


def make_multi_handler(demo: MultiWebDemo):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            qs = parse_qs(url.query)
            try:
                if url.path == "/step":
                    sid = qs["sid"][0]
                    t = float(qs.get("time", ["0"])[0])
                    self._json({"messages": demo.step(sid, t), "time": t})
                elif url.path == "/stats":
                    self._json(demo.stats())
                else:
                    self._json({"error": "not found"}, 404)
            except SlotsFull as e:
                self._json({"error": str(e)}, 409)
            except KeyError as e:
                # missing sid param / unknown session: a client error
                self._json({"error": f"bad or unknown sid: {e.args[0]}"},
                           400)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                return self._json({"error": "bad json"}, 400)
            try:
                sid = str(payload["sid"])
                if self.path == "/load":
                    slot = demo.load(sid, payload)
                    self._json({"ok": True, "slot": slot})
                elif self.path == "/query":
                    demo.query(sid, str(payload.get("text", "")),
                               float(payload.get("time", 0.0)))
                    self._json({"ok": True})
                elif self.path == "/close":
                    self._json({"messages": demo.close(sid)})
                else:
                    self._json({"error": "not found"}, 404)
            except SlotsFull as e:
                self._json({"error": str(e)}, 409)
            except KeyError as e:
                self._json({"error": f"bad or unknown sid: {e.args[0]}"},
                           400)

    return Handler


def serve_multi(ms, frame_fps: float, port: int = 8600):
    """Multi-session server over a MultiStreamEngine (port 0 = ephemeral)."""
    demo = MultiWebDemo(ms, frame_fps)
    httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                make_multi_handler(demo))
    return httpd, demo


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default="")
    p.add_argument("--model_size", default="tiny")
    p.add_argument("--kv_capacity", type=int, default=16384)
    p.add_argument("--kv_quant", default="", choices=["", "int8"])
    p.add_argument("--port", type=int, default=8600)
    p.add_argument("--multi", type=int, default=0,
                   help="N > 0: serve N concurrent browser sessions over "
                        "one MultiStreamEngine (continuous batching)")
    p.add_argument("--stream_tokens", type=int, default=0,
                   help="S > 0: token-streaming responses — partial "
                        "assistant bubbles grow every S decoded tokens "
                        "(single and --multi sessions)")
    p.add_argument("--device", default="",
                   help="'cpu' for the CPU; the card otherwise")
    args = p.parse_args(argv)
    from .cli import build_engine, build_model

    class _A:  # reuse the CLI builder's arg surface
        checkpoint = args.checkpoint
        vision_checkpoint = ""
        tokenizer = ""
        model_size = args.model_size
        dtype = "bfloat16"
        with_vision = False
        kv_capacity = args.kv_capacity
        kv_quant = args.kv_quant
        seed = 0
        stream_tokens = args.stream_tokens
        device = args.device

    S = args.stream_tokens or None
    if args.multi > 0:
        # build params/tokenizer only — a full LiveInferEngine would pin
        # an unused kv_capacity-sized single-stream cache in HBM
        from .multistream import MultiStreamEngine
        params, tok, cfg, vision_params = build_model(_A)
        if S and cfg.max_response_tokens % S:
            # round the budget up so segments tile it exactly (same
            # adjustment cli.build_engine applies)
            cfg = cfg.replace(max_response_tokens=-(
                -cfg.max_response_tokens // S) * S)
        ms = MultiStreamEngine(params, tok, cfg,
                               num_streams=args.multi,
                               kv_capacity=args.kv_capacity,
                               kv_quant=args.kv_quant or None,
                               stream_tokens=S,
                               vision_params=vision_params,
                               device=args.device or None)
        httpd, _ = serve_multi(ms, cfg.frame_fps, port=args.port)
    else:
        engine, cfg = build_engine(_A)
        if S:
            # drop the CLI builder's terminal-print on_delta so WebDemo
            # installs its partial-bubble hook instead
            engine.on_delta = None
        httpd, _ = serve(engine, cfg.frame_fps, port=args.port)
    print(f"serving on http://127.0.0.1:{args.port}", flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
