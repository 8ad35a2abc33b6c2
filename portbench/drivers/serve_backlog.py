"""serve_backlog: the port's batched engine (``MultiStreamEngine``) under a
closed backlog of videos.

Every stream plays the videos of ``traffic.ServePlan`` back to back: all of
a video's frames (pre-extracted SigLIP-large features, through the
connector) and its queries are queued at once, the engine is ticked as fast
as it goes, and a stream whose video is done is closed (``close_stream``)
and given the next video, which the prefix cache admits. Set-up ingests
each stream's first video up to its entry point. The window counts every
frame the engine gates and times each response from the start of the
``step()`` that ingested its query's frame to the return of the ``step()``
that surfaced it.

``correct``: once the window has closed, every stream that has frames
queued and no query pending is asked ``probe_query`` at its next frame, and
the engine is ticked until each has answered: one batched respond program
at the window's batch, over the contexts the window's ingest built; that
``probe_rounds`` times. Then
the engine is freed, and a seeded sample of the dialogues with answers from
the window or the probe (the one with the longest context always in it) is
rebuilt and run through the fp32 reference (``reference/dialogue.py`` over
the configuration's family's reference decoder);
the widest gap by which a served token's reference logit lies below the
reference's best (``max_gap``) and the mean gap over the judged tokens
(``mean_gap``) are read. Before the probe, ``gate_ticks`` more ticks run,
and the gate of every frame ingested in those and in the probe's ticks is
read (``GateTap``); for the sampled dialogues the gate token's margin over
the best other token is worked out again by the reference at each such
frame's last token, and the widest difference is ``gate_gap``. Those
readings that the configuration's ``limits`` name (``serve_<reading>``)
are held to them; ``failed`` counts the judged responses when one is over
its limit. With ``control`` the fp8 control's readings take the program's
place in that comparison (``control_<reading>``), and the program's stay
in the run's stats.
"""

from __future__ import annotations

import contextlib
import gc
import re
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import roofline, tokenizer as tk, trace, traffic, weights
from portbench.reference import common, dialogue

ANSWER = re.compile(r"^\(Video Time = ([-0-9.e+]+)s\) Assistant:(.*)$", re.S)


class FlopMeter:
    """Counts what each decoder forward must do, from the shapes of the
    calls the engine makes: wraps the family's port forward
    (``port_forward``) while it is on, and asks the family what a forward
    needs (``forward_flops``) and which kernels it calls
    (``kernel_calls``)."""

    def __init__(self, family, c: Dict[str, Any]):
        self.family, self.c = family, c
        self.flops = 0.0
        self.calls = []    # per forward: (offsets of its valid streams, S)

    def __enter__(self):
        self._mod, self._name = self.family.port_forward()
        self._orig = getattr(self._mod, self._name)
        meter = self

        def counted(params, **kw):
            cache = kw.get("kv_cache")
            emb = kw.get("inputs_embeds")
            if cache is not None and emb is not None:
                meter.note(emb.shape, cache.offset, kw)
            return meter._orig(params, **kw)

        setattr(self._mod, self._name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self._mod, self._name, self._orig)

    def note(self, shape, offset, kw):
        B, S = int(shape[0]), int(shape[1])
        nv = kw.get("num_valid")
        nv = (np.full(B, S) if nv is None
              else np.asarray(torch.as_tensor(nv).cpu(), np.int64))
        off = np.asarray(offset.cpu(), np.int64)
        rows = 0
        if not kw.get("return_hidden"):
            g = kw.get("logit_gather_positions")
            g = np.asarray(torch.as_tensor(g).cpu(), np.int64)
            g = g.reshape(B, -1)
            rows = int((g < nv[:, None]).sum())
        self.flops += self.family.forward_flops(self.c, nv, off, rows)
        self.calls.append((off[nv > 0], S))

    def kernel_bounds(self) -> Dict[str, Dict[str, Any]]:
        """{class: {bound_s, calls, kind}}: each kernel's least time over
        the forwards with a valid stream, its calls, and the bound kind
        that holds most of that time."""
        acc: Dict[str, Dict[str, Any]] = {}
        for off, S in self.calls:
            if not len(off):
                continue
            for cls, (f, b, layers) in self.family.kernel_calls(
                    self.c, off, S).items():
                a = acc.setdefault(cls, {"bound_s": 0.0, "calls": 0,
                                         "kinds": {}})
                a["calls"] += layers
                s, kind = roofline.least_time(f, b)
                a["bound_s"] += s * layers
                a["kinds"][kind] = a["kinds"].get(kind, 0.0) + s
        return {cls: {"bound_s": a["bound_s"], "calls": a["calls"],
                      "kind": max(a["kinds"], key=a["kinds"].get)}
                for cls, a in acc.items()}


class GateTap:
    """Reads the gate of every frame the engine ingests while it is on:
    wraps the port's ``serve.multistream._gate``, which takes the ingest
    forward's logits at each frame's last token (the gate bias not yet
    added), and keeps per row the margin of the gate token over the best
    other token, in fp32 on the host."""

    def __init__(self):
        self.margins = None

    def __enter__(self):
        from videollm_online_tpu_torch.serve import multistream
        self._mod, self._orig = multistream, multistream._gate
        tap = self

        def tapped(rows, gate_id, *a, **k):
            tap.margins = dialogue.gate_margin(rows.float(),
                                                 gate_id).cpu().numpy()
            return tap._orig(rows, gate_id, *a, **k)

        multistream._gate = tapped
        return self

    def __exit__(self, *exc):
        self._mod._gate = self._orig

    def take(self):
        """The margins of the last ingest, (N,) or (N, K); None if none."""
        m, self.margins = self.margins, None
        return m


class Client:
    """The benchmark's side of the engine: feeds videos, ticks, records."""

    def __init__(self, eng, plan, bank, mix, fps):
        self.eng, self.plan, self.bank, self.mix, self.fps = (
            eng, plan, bank, mix, fps)
        N = plan.N
        self.video = [0] * N           # index of each stream's video
        self.spec = [plan.video(i, 0) for i in range(N)]
        self.consumed = [0] * N        # frames of the current video gated
        self.dialogues: List[Dict[str, Any]] = [
            self._new_dialogue(i) for i in range(N)]
        self.done: List[Dict[str, Any]] = []
        self.qstart: Dict[tuple, float] = {}
        self.answered = set()
        self.latency: List[float] = []
        self.in_window = False
        self.probing = False
        self.gated = 0
        self.responses = 0
        self.tap = None

    def _new_dialogue(self, i):
        return {"stream": i, "video": self.video[i], "spec": self.spec[i],
                "responses": [], "gates": []}

    def feed(self, i, start, stop):
        """Queue frames [start, stop) of stream i's video and its queries on
        those frames."""
        if stop <= start:
            return
        v = self.spec[i]
        self.eng.input_frames(i, start / self.fps,
                              traffic.video_features(self.bank, v, start,
                                                     stop))
        for f, text in v["queries"]:
            if start <= f < stop:
                self.eng.input_query(i, text, f / self.fps)

    def probe(self, text, rounds, max_ticks=64):
        """``rounds`` times: ask every stream with frames queued and no
        query pending ``text`` at its next frame, and tick until each has
        answered. Returns (asked, answered) over the rounds."""
        eng = self.eng
        n_asked = n_answered = 0
        self.probing = True
        for _ in range(rounds):
            asked = [i for i in range(self.plan.N)
                     if eng.frame_queues[i] and not eng.query_queues[i]]
            for i in asked:
                eng.input_query(i, text, eng.frame_queues[i][0][0])
            self.answered = set()
            for _ in range(max_ticks):
                if self.answered.issuperset(asked):
                    break
                self.tick()
            n_asked += len(asked)
            n_answered += len(self.answered.intersection(asked))
        self.probing = False
        return n_asked, n_answered

    def tick(self):
        eng, N = self.eng, self.plan.N
        before = [len(q) for q in eng.frame_queues]
        t0 = time.perf_counter()
        out = eng.step()
        t1 = time.perf_counter()
        margins = self.tap.take() if self.tap is not None else None
        if margins is not None:
            margins = margins.reshape(N, -1)
        for i in range(N):
            k = before[i] - len(eng.frame_queues[i])
            if k:
                c0 = self.consumed[i]
                if margins is not None:
                    self.dialogues[i]["gates"].extend(
                        (c0 + j, float(margins[i, j])) for j in range(k))
                for f, _ in self.spec[i]["queries"]:
                    if c0 <= f < c0 + k:
                        self.qstart[(i, self.video[i], f)] = t0
                self.consumed[i] += k
                if self.in_window:
                    self.gated += k
            if out[i] is not None:
                self._answer(i, out[i], t1)
        return t0, t1

    def _answer(self, i, result, t1):
        q_str, a_str = result
        m = ANSWER.match(a_str)
        frame = int(round(float(m.group(1)) * self.fps))
        query = None
        if q_str is not None:
            query = q_str.split(" User: ", 1)[1]
        self.dialogues[i]["responses"].append({
            "frame": frame, "query": query, "ids": tk.ids_of(m.group(2)),
            "judge": self.in_window or self.probing})
        self.answered.add(i)
        if self.in_window:
            self.responses += 1
            t0 = self.qstart.pop((i, self.video[i], frame), None)
            if t0 is not None and query is not None:
                self.latency.append(t1 - t0)

    def turn_over(self):
        """Close every stream whose video is done and start its next one."""
        eng = self.eng
        for i in range(self.plan.N):
            if eng.frame_queues[i] or eng.query_queues[i]:
                continue
            if self.consumed[i] < self.spec[i]["length"]:
                continue
            eng.close_stream(i)
            self.done.append(self.dialogues[i])
            self.video[i] += 1
            self.spec[i] = self.plan.video(i, self.video[i])
            self.consumed[i] = 0
            self.dialogues[i] = self._new_dialogue(i)
            self.feed(i, 0, self.spec[i]["length"])

    def all_dialogues(self):
        return self.done + self.dialogues


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(ctx) -> Dict[str, Any]:
    from videollm_online_tpu_torch.serve.multistream import MultiStreamEngine
    from videollm_online_tpu_torch.tokenizer.live_tokenizer import (
        LiveTokenizer)

    c, mix, seed, dev, fam = (ctx.config, ctx.mix, ctx.seed, ctx.device,
                              ctx.family)
    live = c["live"]
    cfg = fam.live_config(c, max_response_tokens=mix["max_new_tokens"],
                          gate_logit_bias=mix["gate_bias"])
    tok = LiveTokenizer(tk.IdTokenizer(), cfg)
    cfg = tok.cfg
    need = traffic.worst_dialogue_tokens(mix, live["system_prompt"],
                                         live["frame_num_tokens"])
    if need > mix["kv_capacity"]:
        raise ValueError(f"the longest dialogue needs {need} KV slots, more "
                         f"than kv_capacity {mix['kv_capacity']}")
    params = weights.make(fam, c, seed, dev)
    plan = traffic.ServePlan(mix, seed)
    bank = traffic.feature_bank(seed, mix["bank_frames"],
                                live["frame_num_tokens"],
                                live["vision_hidden_size"])
    eng = MultiStreamEngine(
        params, tok, cfg, num_streams=mix["streams"],
        kv_capacity=mix["kv_capacity"], max_new_tokens=mix["max_new_tokens"],
        chunk_frames=mix["chunk_frames"], spec_decode=mix["spec_decode"],
        page_size=mix["page_size"], prefix_cache=True, device=dev)
    fps = float(live["frame_fps"])
    cl = Client(eng, plan, bank, mix, fps)
    if ctx.patch is not None:
        ctx.patch(eng)

    # set-up: each stream's first video up to its entry point, then the rest
    # of it queued
    entry = [plan.entry(i) for i in range(plan.N)]
    for i in range(plan.N):
        cl.feed(i, 0, entry[i])
    while any(eng.frame_queues):
        cl.tick()
    for i in range(plan.N):
        cl.feed(i, entry[i], cl.spec[i]["length"])
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t0

    record: Dict[str, Any] = {"trace": None}
    if ctx.trace:
        with trace.profiled(ctx.out_dir, lambda: _sync(dev),
                            fam.KERNEL_CLASSES) as prof, \
                FlopMeter(fam, c) as kmeter:
            t_end = time.perf_counter() + mix["profile_seconds"]
            while time.perf_counter() < t_end:
                cl.tick()
                cl.turn_over()
        record["trace"] = prof["summary"]
        record["kernel_bounds"] = kmeter.kernel_bounds()
        record["trace_read_s"] = prof["read_s"]

    spec0 = eng.spec_stats()
    cl.in_window = True
    ticks = []
    _sync(dev)
    gated_at = []          # (seconds into the window, frames gated so far)
    with (FlopMeter(fam, c) if ctx.trace
          else contextlib.nullcontext()) as meter:
        w0 = time.perf_counter()
        end = w0 + ctx.seconds
        while True:
            t0, t1 = cl.tick()
            ticks.append(t1 - t0)
            gated_at.append((t1 - w0, cl.gated))
            cl.turn_over()
            if time.perf_counter() >= end:
                break
        _sync(dev)
    window_s = time.perf_counter() - w0
    cl.in_window = False
    spec1 = eng.spec_stats()
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    # after the window, at its batch: the gates of ``gate_ticks`` ticks and
    # of the probe's are read, then the probe's answers
    with GateTap() as cl.tap:
        for _ in range(mix["gate_ticks"]):
            cl.tick()
        asked, answered = cl.probe(mix["probe_query"], mix["probe_rounds"])
    cl.tap = None

    record.update(
        ticks_s=ticks, window_s=window_s,
        spec={"steps": int(spec1[0] - spec0[0]),
              "tokens": int(spec1[1] - spec0[1])},
        flops_serve=None if meter is None else meter.flops)
    lat = sorted(cl.latency)
    e2e = {"frames_per_s": cl.gated / window_s}
    if lat:
        e2e["response_p95_ms"] = float(np.percentile(lat, 95)) * 1e3

    # the engine's state goes before the reference runs
    dialogues = [d for d in cl.all_dialogues()
                 if any(r["judge"] for r in d["responses"])]
    del eng, cl
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    checks, stats = judge_sample(ctx, params, bank, dialogues)
    stats.update(probes_asked=asked, probes_answered=answered,
                 frames_per_s_by_5s=by_slice(gated_at, 5.0))
    checks["probes_unanswered"] = {"value": asked - answered, "limit": 0}
    failed = int(stats.get("failed", 0)) + asked - answered
    return {"setup_s": setup_s, "metrics": e2e, "record": record,
            "attempted": int(stats.get("responses", 0)), "failed": failed,
            "checks": checks, "correct": (failed == 0 and stats["tokens"] > 0
                                          and asked > 0),
            "memory_peak_bytes": int(peak), "stats": stats,
            "responses_in_window": sum(
                1 for d in dialogues for r in d["responses"] if r["judge"])}


def by_slice(gated_at, width):
    """Frames gated per second in each ``width``-second slice of the
    window, from the ticks' (end time, frames gated so far): a steady
    window reads alike in every slice."""
    out, prev_t, prev_n, edge = [], 0.0, 0, width
    for t, n in gated_at:
        if t >= edge:
            out.append(round((n - prev_n) / (t - prev_t), 1))
            prev_t, prev_n, edge = t, n, edge + width
    return out


def judge_sample(ctx, params, bank, dialogues):
    """Rebuild a seeded sample of the dialogues that answered in the window
    (the longest always in it), judge their in-window responses."""
    c, mix = ctx.config, ctx.mix
    live = c["live"]
    if not dialogues:
        return ({"served_tokens": {"value": 0, "limit": 1}},
                {"tokens": 0, "responses": 0, "failed": 1})

    def reach(d):
        return max(r["frame"] for r in d["responses"] if r["judge"])

    dialogues = sorted(dialogues, key=lambda d: (d["stream"], d["video"]))
    longest = max(range(len(dialogues)), key=lambda k: reach(dialogues[k]))
    rng = np.random.default_rng(weights.sub_seed(ctx.seed, 20))
    rest = [k for k in range(len(dialogues)) if k != longest]
    n = min(mix["sample_dialogues"] - 1, len(rest))
    pick = [longest] + [rest[k] for k in sorted(
        rng.choice(len(rest), size=n, replace=False))] if n else [longest]
    common.exact_fp32()
    iv = tk.encode(tk.INTERVAL)[0]
    seqs, judged, gated = [], [], []
    for k in pick:
        d = dict(dialogues[k])
        last = reach(d)
        d["responses"] = [r for r in d["responses"] if r["frame"] <= last]
        d["frame_num_tokens"] = live["frame_num_tokens"]
        items, jd, gates = dialogue.layout(d, live["system_prompt"], iv)
        spec = d["spec"]
        seqs.append(dialogue.embed(
            ctx.family.reference, items, params,
            lambda j, spec=spec: traffic.video_features(bank, spec, j, j + 1)[0],
            ctx.device))
        judged.append(jd)
        gated.append(gates)
    t0 = time.perf_counter()
    with torch.no_grad():
        stats = dialogue.judge(ctx.family.reference, params, c, seqs, judged,
                               gated, iv, control=ctx.control)
    stats["reference_s"] = time.perf_counter() - t0
    stats["dialogues"] = len(pick)
    stats["longest_tokens"] = max(int(s.shape[0]) for s in seqs)
    stats["responses"] = sum(1 for d in dialogues for r in d["responses"]
                             if r["judge"])
    stats["judged_responses"] = sum(len({r for _, _, r in jd})
                                    for jd in judged)
    gaps = stats.pop("gaps")
    # the control's numbers take the program's place under its own names,
    # so a control run is judged as the program's runs are
    prefix = "control_" if ctx.control else ""
    compared = {prefix + k[len("serve_"):]: v
                for k, v in c["limits"].items() if k.startswith("serve_")}
    checks = {name: {"value": stats[name], "limit": limit}
              for name, limit in compared.items()}
    checks["served_tokens"] = {"value": stats["tokens"], "limit": 1}
    checks["judged_gates"] = {"value": stats["gates"], "limit": 1}
    wrong = (any(stats[n] > v for n, v in compared.items())
             or stats["gates"] < 1)
    stats["failed"] = stats["judged_responses"] if wrong else 0
    stats["largest_gaps"] = sorted(gaps.tolist())[-5:]
    return checks, stats
