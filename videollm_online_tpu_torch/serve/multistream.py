"""Batched multi-stream serving: N concurrent video dialogues, one model.

Counterpart of ``videollm_online_tpu/serve/multistream.py``
(``MultiStreamEngine``), its blocking tick ``_step_unfused``: per tick, one
batched forward ingests up to ``chunk_frames`` queued frames of every
stream that has some (a 1-frame step when no stream has more than one) and
reads every frame's gate; a second batched program answers every stream
whose gate fired or whose query came due (greedy, or n-gram speculative
with ``spec_decode``). Per-stream conversation state (queues, prepends,
transcripts) lives on the host; device work is batch-N shaped.

The KV cache is the paged pool (``models.llama.PagedKVCache``, attention
through K3) or the batched ring (``KVCache``), chosen as the JAX engine
chooses it; both may be int8 (``kv_quant``). The host owns the page
allocator, its refcounts (``fork_stream`` aliases full pages), the prefix
cache that admits a new dialogue by aliasing the system prompt's pages,
and ``stream_window`` compaction (pages freed, or the ring rolled).

With ``stream_tokens`` = S a response is decoded S tokens at a time: it
stays open (its stream ingests nothing meanwhile) and each later tick
first runs one batched continuation segment over every open response,
each surfaced through ``on_delta(stream, delta, done)``; the joined
segments are the unsegmented response. With ``vision_params``,
``input_frames`` takes raw uint8 frames (T, 3, H, W) and encodes them
through the SigLIP tower and the connector.

The JAX engine's ``fused=True`` tick is one device dispatch whose
transcripts its own tests prove equal to the blocking tick's; here
``fused`` runs the same blocking tick. With ``pipelined`` the tick's
batched ingest is dispatched up to ``pipeline_depth`` ticks ahead of its
gates being read: each dispatch's gate ids travel to a pinned host buffer
of their own (``core.device.DeferredRead``), the host offsets advance on
the guess that no gate fires, and a stream whose gate fired gets its newer
frames re-queued and its offset rewound while the other streams keep their
work. A stream is not dispatched past a query turn; responses run at
resolution. Transcripts are the blocking tick's; a response may surface a
step later, and ``flush()`` resolves what is in flight. After a rollback
the streams can share ticks otherwise than in the blocking tick, so a
1-frame burst can go out in the other of its two layouts, which rounds
differently in bf16 (ROADMAP, documented divergences).

Under a tensor-parallel mesh (``parallel.mesh.maybe_mesh`` around the
engine, params cut ``tp``) every rank runs the same tick: the gate ids
each rank reads back come from logits all-gathered whole on every rank,
so all ranks dispatch, resolve and roll back alike and their collectives
stay in step. Where those collectives stage through host buffers (gloo on
the card) each of them makes the host wait, so nothing runs ahead there;
the transcripts are the same.

Each phase of a tick runs inside a span (``LatencyHistogram.measure``):
``multistream.admit`` (prefill or prefix admission, the tick's collection
and capacity guard), ``.ingest`` (the batched ingest's dispatch),
``.settle`` (the gate readback, its bookkeeping, the schedule) and
``.respond`` (a respond program; its prompt forward ``.respond.prefill``,
each decode or verify forward ``.respond.decode``); the page allocator's
work is ``.pages`` inside them; ``input_*`` and ``close_stream`` are
``.input`` and ``.close``. No span covers a whole ``step()``. Their host
times feed ``stats()["phases"]``, and while ``torch.profiler`` records each
is a range on its timeline. ``counters()`` counts the respond programs,
their decode forwards, the batch rows those forwards fed and, of those,
the rows of streams not yet done.

On a card, over the paged pool and with no tensor-parallel mesh, the
greedy decode forward (with its argmax) is captured once as a CUDA graph
(``models.llama.DecodeGraph``) at its first use and replayed at every
later step: the host builds the forward's index tensors as the eager
forward does and stages them in one copy. ``counters()`` counts the
captures and the replays beside the decode forwards. Everything else (the
ring, TP serving, the spec verify forward, the prompt and ingest
forwards, the CPU) runs the eager forward.
"""

from __future__ import annotations

import collections
import dataclasses
import time as _time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import LiveConfig
from ..core.device import DeferredRead, resolve_device, to_device
from ..models import generate as gen_mod
from ..models import live, llama
from ..parallel.context import ParallelContext
from ..tokenizer.live_tokenizer import LiveTokenizer
from ..utils.profiling import LatencyHistogram
from .engine import DispatchCounts, _check_same_tree

TEXT_BUCKET = 4
PROMPT_BUCKET = 128
CHUNK_FRAMES = 8
ENCODE_FRAMES = 32     # frames a tower batch: a long clip in bounded memory


def _gate(rows: torch.Tensor, gate_id: int, threshold: float, bias: float
          ) -> torch.Tensor:
    """rows (..., V) logits -> next ids (...): the gate token's probability
    is zeroed before the argmax when it is below the threshold (fp32
    softmax, the gate bias added first)."""
    rows = rows.float()
    if bias:
        rows = rows.clone()
        rows[..., gate_id] += bias
    probs = torch.softmax(rows, dim=-1)
    below = probs[..., gate_id] < threshold
    probs[..., gate_id] = torch.where(
        below, torch.zeros((), dtype=probs.dtype, device=probs.device),
        probs[..., gate_id])
    return torch.argmax(probs, dim=-1)


def _greedy_ids(logits: torch.Tensor) -> torch.Tensor:
    """(N, 1, V) logits of a decode forward -> the (N,) greedy next ids."""
    return torch.argmax(logits[:, 0], dim=-1)


def _roll_valid_first(embeds: torch.Tensor, n, bucket: int) -> torch.Tensor:
    """Per row b, roll (T, D) left by ``bucket - n[b]``: right-aligned valid
    rows of the leading bucket move to the front (the JAX package's
    vmapped ``jnp.roll``)."""
    B, T = embeds.shape[:2]
    shift = bucket - torch.as_tensor(np.asarray(n), dtype=torch.long)
    idx = to_device((torch.arange(T)[None] + shift[:, None]) % T,
                    embeds.device)
    return torch.gather(embeds, 1,
                        idx[..., None].expand(-1, -1, embeds.shape[2]))


class MultiStreamEngine:
    """The JAX engine's constructor signature; ``fused`` is accepted and
    changes nothing (one blocking tick), ``pipelined`` dispatches ticks
    ahead (module docstring), ``device`` picks the card (the default) or
    ``"cpu"``."""

    def __init__(self, params, tokenizer: LiveTokenizer,
                 cfg: Optional[LiveConfig] = None, *, num_streams: int = 8,
                 kv_capacity: int = 8192, frame_fps: Optional[float] = None,
                 max_new_tokens: Optional[int] = None, attn_impl=None,
                 chunk_frames: int = CHUNK_FRAMES,
                 stream_window: Optional[int] = None,
                 fused: bool = True, pipelined: bool = False,
                 pipeline_depth: int = 2,
                 kv_quant: Optional[str] = None,
                 spec_decode: bool = False,
                 spec_draft: Optional[int] = None,
                 spec_draft_mode: str = "ngram",
                 stream_tokens: Optional[int] = None,
                 on_delta=None,
                 paged=None, page_size: int = 512,
                 pool_pages: Optional[int] = None,
                 prefix_cache: bool = True,
                 vision_params=None,
                 max_lag_frames: Optional[int] = None,
                 device=None):
        if pipelined and stream_tokens is not None:
            raise ValueError("stream_tokens is a blocking-tick mode (no "
                             "pipelined dispatch)")
        self.pipelined = pipelined
        self.pipeline_depth = max(1, pipeline_depth)
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant {kv_quant!r}")
        if spec_draft_mode not in ("ngram", "zero"):
            raise ValueError(f"spec_draft_mode {spec_draft_mode!r}")
        if max_lag_frames is not None and max_lag_frames < 1:
            raise ValueError(f"max_lag_frames {max_lag_frames} < 1")
        self.device = resolve_device(device)
        self.kv_quant = kv_quant
        self.spec_decode = spec_decode
        # K = response budget - 1, capped at 19: one verify forward can emit
        # a whole predicted response
        self.spec_draft = int(
            spec_draft
            or max(1, min((max_new_tokens
                           or (cfg or tokenizer.cfg).max_response_tokens)
                          - 1, 19)))
        self.spec_draft_mode = spec_draft_mode
        # paged=None: paged iff the capacity holds 2 pages beyond any window
        if paged is None:
            paged = kv_capacity >= 2 * page_size + (stream_window or 0)
        self.paged = paged
        self.prefix_cache = bool(prefix_cache) and self.paged
        self.page_size = page_size
        self._maxp = -(-kv_capacity // page_size)
        self.pool_pages = (pool_pages if pool_pages is not None
                           else num_streams * self._maxp + 1)
        self.params = params
        self.tokenizer = tokenizer
        self.cfg = cfg or tokenizer.cfg
        # each stream compacts on its own: windowed attention + pages freed
        # (paged) or the ring rolled (ring), as the single-stream contract
        self.stream_window = stream_window
        if stream_window is not None:
            need = (stream_window + TEXT_BUCKET
                    + chunk_frames * (self.cfg.frame_num_tokens + 1)
                    + PROMPT_BUCKET
                    + (max_new_tokens or self.cfg.max_response_tokens))
            if kv_capacity < need:
                raise ValueError(f"kv_capacity {kv_capacity} too small for "
                                 f"stream_window {stream_window}: needs >= "
                                 f"{need}")
            self.cfg = self.cfg.replace(llama=dataclasses.replace(
                self.cfg.llama, sliding_window=stream_window))
        # a stream whose frame queue exceeds this sheds its OLDEST frames at
        # the next tick; None = never drop
        self.max_lag_frames = max_lag_frames
        self.N = num_streams
        self.kv_capacity = kv_capacity
        self.frame_fps = frame_fps or self.cfg.frame_fps
        self.fnt = self.cfg.frame_num_tokens
        self.hidden = self.cfg.llama.hidden_size
        self.max_new = max_new_tokens or self.cfg.max_response_tokens
        # stream_tokens = S: device responses decode at most S tokens; a
        # response that fills its segment stays open and continues one
        # segment a tick (the whole budget is reserved by the tick that
        # opened it)
        self.resp_budget = self.max_new
        self.stream_tokens = stream_tokens
        self.on_delta = on_delta
        if stream_tokens is not None:
            if stream_tokens <= 0 or self.resp_budget % stream_tokens:
                raise ValueError(
                    f"stream_tokens {stream_tokens} must be positive and "
                    f"divide the response budget {self.resp_budget}")
            self.max_new = stream_tokens
            if spec_decode and spec_draft is None:
                # K = S - 1: one verify step can complete a segment
                self.spec_draft = (max(1, min(self.spec_draft,
                                              stream_tokens - 1))
                                   if stream_tokens > 1 else 1)
        # raw uint8 frames encode through the tower on the engine's device
        self.vision_params = vision_params
        self.chunk_frames = max(1, chunk_frames)
        if attn_impl is None:
            from ..ops.auto import auto_attention
            attn_impl = auto_attention
        self.attn_impl = attn_impl
        lora = params.get("lora")
        self._lora_scaling = (self.cfg.lora.scaling if (
            self.cfg.lora is not None and lora is not None) else 1.0)
        iv = self.cfg.frame_token_interval_id
        self._gate_id = iv if iv is not None else self.cfg.eos_token_id

        tok = tokenizer
        self._start_ids = list(tok.apply_chat_template(
            [{"role": "system", "content": self.cfg.system_prompt}],
            tokenize=True, add_stream_prompt=True))
        self._stream_prompt_ids = list(tok.encode("\n["))
        self._gen_prompt_ids = list(tok.encode("]\nAssistant:"))
        self.reset()

    # ---------------------------------------------------- device programs
    def _fwd(self, embeds, num_valid, gather_pos=None, return_hidden=False,
             decode_graph=None):
        logits, self.cache = llama.forward(
            self.params["llama"], cfg=self.cfg.llama, inputs_embeds=embeds,
            kv_cache=self.cache,
            num_valid=torch.as_tensor(np.asarray(num_valid), dtype=torch.int32),
            lora=self.params.get("lora"), lora_scaling=self._lora_scaling,
            attn_impl=self.attn_impl, logit_gather_positions=gather_pos,
            return_hidden=return_hidden, decode_graph=decode_graph)
        return logits

    def _decode_graph(self) -> Optional[llama.DecodeGraph]:
        """The greedy decode forward's graph holder where that forward can
        be replayed as a CUDA graph (a card, the paged pool, no
        tensor-parallel mesh), else None: the eager forward."""
        if self.device.type == "cuda" and self.paged and \
                ParallelContext.current(self.cfg.llama) is None:
            return self._graph
        return None

    def _embed(self, ids) -> torch.Tensor:
        return llama.embed_tokens(
            self.params["llama"], torch.as_tensor(np.asarray(ids)),
            self.cfg.llama)

    def _dispatch_ingest(self, coll) -> Dict[str, Any]:
        """Dispatch a tick's batched ingest (``_collect_ingest``'s bursts),
        taking the active streams' prepends, and start reading its gate ids
        back without waiting for them: a 1-frame step when no stream has
        more than one frame ([prepend, frame] of every active stream, its
        gate at the frame's last token), else ONE chunked forward (per
        active stream [prepend] f0 , f1 ... up to chunk_frames frames, a
        gate at every frame's last token, zero frames past its burst).
        Returns the in-flight tick: the collection, the offsets before it
        and the gate ids' readback."""
        N, fnt = self.N, self.fnt
        active, bursts = coll["active"], coll["bursts"]
        text_ids, n_text = coll["text_ids"], coll["n_text"]
        for i in np.flatnonzero(active):
            self.prepends[i] = []
        base = self.cache.offset.numpy().astype(np.int64)
        t_emb = self._embed(text_ids)
        if coll["max_burst"] <= 1:
            frames = torch.zeros((N, fnt, self.hidden),
                                 dtype=self._frame_dtype(bursts),
                                 device=self.device)
            for i in np.flatnonzero(active):
                src, j = bursts[i][0][1]
                frames[i] = src[j]
            embeds = _roll_valid_first(
                torch.cat([t_emb, frames.to(t_emb.dtype)], dim=1), n_text,
                TEXT_BUCKET)
            num_valid = np.where(active, n_text + fnt, 0)
            gather = torch.as_tensor(np.maximum(num_valid - 1, 0))
            logits = self._fwd(embeds, num_valid, gather)[:, 0]
        else:
            K = self.chunk_frames
            n_frames = np.array([len(b) for b in bursts], np.int64)
            iv = self.cfg.frame_token_interval_id
            itv = 1 if iv is not None else 0
            f_emb = self._gather_chunks(bursts, active, K).to(t_emb.dtype)
            D = t_emb.shape[-1]
            if itv:
                iv_emb = self._embed([[iv]])[0]                  # (1, D)
                unit = torch.cat([iv_emb[None, None].expand(N, K, 1, D),
                                  f_emb], dim=2)
                body = torch.cat([f_emb[:, 0],
                                  unit[:, 1:].reshape(N, -1, D)], dim=1)
            else:
                body = f_emb.reshape(N, -1, D)
            embeds = _roll_valid_first(torch.cat([t_emb, body], dim=1),
                                       n_text, TEXT_BUCKET)
            valid = np.where(active, n_text + n_frames * fnt
                             + np.maximum(n_frames - 1, 0) * itv, 0)
            ends = torch.as_tensor(n_text[:, None] + fnt - 1
                                   + np.arange(K)[None] * (fnt + itv))
            logits = self._fwd(embeds, valid, ends)               # (N, K)
        cfg = self.cfg
        ids = _gate(logits, self._gate_id,
                    float(cfg.frame_token_interval_threshold),
                    cfg.gate_logit_bias)
        self._counts.dispatched()
        return {"coll": coll, "base": base, "ids": DeferredRead(ids)}

    def _settle_ingest(self, e):
        """Read an in-flight tick's gate ids (waiting on its own readback
        alone). Per stream still active in it: frames consumed up to and
        including its first fired frame, whether one fired, the next id
        after its last consumed frame, and the ring slots those frames
        take. Returns (consumed, fire, next_id, tokens)."""
        coll = e["coll"]
        active, n_text, fnt = coll["active"], coll["n_text"], self.fnt
        ids = self._counts.read(e["ids"]).numpy()
        if coll["max_burst"] <= 1:
            fire = active & (ids != self._gate_id)
            consumed = active.astype(np.int64)
            return consumed, fire, ids, np.where(active, n_text + fnt, 0)
        N, K = ids.shape
        itv = 1 if self.cfg.frame_token_interval_id is not None else 0
        n_frames = np.array([len(b) for b in coll["bursts"]], np.int64)
        fires = ((ids != self._gate_id) & (np.arange(K)[None]
                                           < n_frames[:, None])
                 & active[:, None])
        fire = fires.any(axis=1)
        consumed = np.where(fire, fires.argmax(axis=1) + 1, n_frames)
        consumed = np.where(active, consumed, 0)
        tokens = np.where(active, n_text + consumed * fnt
                          + np.maximum(consumed - 1, 0) * itv, 0)
        last = np.clip(consumed - 1, 0, K - 1)
        return consumed, fire, ids[np.arange(N), last], tokens

    def _prompt_embeds(self, prompt_ids, num_valid):
        return _roll_valid_first(self._embed(prompt_ids), num_valid,
                                 prompt_ids.shape[1])

    def _respond_core(self, prompt_ids, num_valid, active):
        """Batched greedy decode of the active streams: the prompt forward,
        then one 1-token forward per step for every stream not yet done
        (done streams append nothing); where ``_decode_graph`` gives a
        holder, that forward and its argmax are one CUDA graph, replayed.
        Returns (out (N, max_new), lengths)."""
        N, max_new, eos = self.N, self.max_new, self.cfg.eos_token_id
        nv = np.where(active, num_valid, 0)
        with self._span("multistream.respond.prefill"):
            logits = self._fwd(self._prompt_embeds(prompt_ids, num_valid), nv,
                               torch.as_tensor(np.maximum(nv - 1, 0)))
            first = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        out = np.zeros((N, max_new), np.int64)
        out[:, 0] = first
        done = ~active | (first == eos)
        lengths = np.where(active, 1, 0)
        i = 1
        while i < max_new and not done.all():
            self._count_decode(done)
            with self._span("multistream.respond.decode"):
                graph = self._decode_graph()
                logits = self._fwd(self._embed(out[:, i - 1:i]),
                                   (~done).astype(np.int32),
                                   torch.zeros((N,), dtype=torch.long),
                                   decode_graph=graph)
                nxt = (_greedy_ids(logits) if graph is None
                       else graph.post_out).cpu().numpy()
            nxt = np.where(done, eos, nxt)
            out[:, i] = nxt
            lengths = np.where(done, lengths, i + 1)
            done = done | (nxt == eos)
            i += 1
        return out, lengths

    def _hist_append(self, i: int, ids, n: int):
        self._hist[i], self._hcount[i] = gen_mod.hist_append_ids(
            self._hist[i], self._hcount[i], torch.as_tensor(np.asarray(ids)),
            int(n))

    def _respond_core_spec(self, prompt_ids, num_valid, active, hist_nv=None):
        """Batched n-gram speculative decode: the greedy core's exact token
        streams, up to ``spec_draft + 1`` tokens per stream per verify
        forward. Every stream's history ring takes its prompt (``hist_nv``
        of its tokens when given: 0 for a continuation segment, whose
        1-token prompt is there already as the last emitted token) and its
        emitted tokens; ``_sstats`` accumulates [verify steps, emitted] over
        the streams."""
        N, max_new, eos, K = (self.N, self.max_new, self.cfg.eos_token_id,
                              self.spec_draft)
        P = prompt_ids.shape[1]
        nv = np.where(active, num_valid, 0)
        hn = nv if hist_nv is None else np.where(active, hist_nv, 0)
        for i in np.flatnonzero(hn):
            self._hist_append(i, np.roll(prompt_ids[i], -(P - nv[i])), hn[i])
        with self._span("multistream.respond.prefill"):
            logits = self._fwd(self._prompt_embeds(prompt_ids, num_valid), nv,
                               torch.as_tensor(np.maximum(nv - 1, 0)))
            first = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        out = np.zeros((N, max_new), np.int64)
        out[:, 0] = first
        done = ~active | (first == eos)
        lengths = np.where(active, 1, 0)
        for i in np.flatnonzero(active):
            self._hist_append(i, first[i:i + 1], 1)
        nact = int(active.sum())
        self._sstats += torch.tensor([nact, nact], dtype=torch.int32)
        i_n = np.where(active, 1, 0)
        kk = np.arange(K + 1)
        gpos = torch.arange(K + 1)[None].expand(N, K + 1)
        while not done.all():
            prev = out[np.arange(N), np.clip(i_n - 1, 0, max_new - 1)]
            drafts = np.zeros((N, K), np.int64)
            if self.spec_draft_mode == "ngram":
                for i in np.flatnonzero(~done):
                    drafts[i] = gen_mod._ngram_draft(
                        self._hist[i], self._hcount[i], K).numpy()
            toks = np.concatenate([prev[:, None], drafts], axis=1)
            off0 = self.cache.offset
            feed = np.where(done, 0, K + 1)
            self._count_decode(done)
            with self._span("multistream.respond.decode"):
                logits = self._fwd(self._embed(toks), feed, gpos)
                preds = torch.argmax(logits, dim=-1).cpu().numpy()  # (N, K+1)
            mism = preds[:, :K] != drafts
            emit = np.where(mism, kk[None, :K], K).min(axis=1) + 1
            is_eos = (preds == eos) & (kk[None] < emit[:, None])
            e_idx = np.where(is_eos, kk[None], K + 1).min(axis=1)
            hit_eos = e_idx <= K
            emit = np.where(hit_eos, e_idx + 1, emit)
            emit = np.minimum(emit, max_new - i_n)
            emit = np.where(done, 0, emit)
            for i in np.flatnonzero(emit):
                out[i, i_n[i]:i_n[i] + emit[i]] = preds[i, :emit[i]]
                self._hist_append(i, preds[i], emit[i])
            # keep `emit` KV entries per stream: the newest emitted token's
            # KV stays out of the cache, as in the greedy core
            self.cache = self.cache.replace(offset=off0 + torch.as_tensor(
                emit, dtype=torch.int32))
            lengths = np.where(done, lengths, i_n + emit)
            self._sstats += torch.tensor(
                [int((~done).sum()), int(emit.sum())], dtype=torch.int32)
            done = done | hit_eos | (i_n + emit >= max_new)
            i_n = i_n + emit
        return out, lengths

    def _count_decode(self, done):
        """One decode (or verify) forward over all N rows, of which the
        streams not yet ``done`` are fed."""
        c = self._counters
        c["decode_forwards"] += 1
        c["decode_rows"] += self.N
        c["decode_rows_valid"] += int((~done).sum())

    def _respond(self, prompt_ids, num_valid, active, hist_nv=None):
        """Greedy or speculative batched respond. Returns (out, lengths)."""
        self._counters["respond_programs"] += 1
        if self.spec_decode:
            return self._respond_core_spec(prompt_ids, num_valid, active,
                                           hist_nv)
        return self._respond_core(prompt_ids, num_valid, active)

    def _prefill(self, ids, nv, active):
        num_valid = np.where(active, nv, 0)
        # the prompt's logits are unused: skip the lm_head
        self._fwd(self._prompt_embeds(ids, nv), num_valid,
                  torch.as_tensor(np.maximum(num_valid - 1, 0)),
                  return_hidden=True)

    def _pools(self):
        c = self.cache
        return [c.k, c.v] + ([c.k_scale, c.v_scale] if c.quantized else [])

    def _copy_page(self, p_new: int, p_old: int):
        """One page (every layer, every pool) copied in place."""
        for pool in self._pools():
            pool[:, p_new] = pool[:, p_old]

    def _copy_page_multi(self, p_src: int, dsts: List[int]):
        """One source page copied into each of ``dsts``, in place."""
        idx = to_device(torch.as_tensor(dsts), self.device)
        for pool in self._pools():
            pool.index_copy_(1, idx, pool[:, p_src:p_src + 1].expand(
                (-1, len(dsts)) + pool.shape[2:]).contiguous())

    def _mask_set_offsets(self, mask, vals):
        m = torch.as_tensor(mask)
        self.cache = self.cache.replace(
            offset=torch.where(m, torch.as_tensor(vals, dtype=torch.int32),
                               self.cache.offset),
            pos_base=torch.where(m, 0, self.cache.pos_base).to(torch.int32))

    def _sync_offsets(self, mask=None):
        """The host offsets of the ``mask`` streams (all by default) from
        the cache's."""
        off = self.cache.offset.numpy()
        if mask is None:
            self._host_offsets[:] = off
        else:
            self._host_offsets[mask] = off[mask]

    # ---------------------------------------------------------------- state
    def reset(self):
        if self.paged:
            self.cache = llama.init_paged_kv_cache(
                self.cfg.llama, batch=self.N, pool_pages=self.pool_pages,
                pages_per_stream=self._maxp, page_size=self.page_size,
                quant=self.kv_quant, device=self.device)
            # host-owned page allocator: pool page 0 is the TRASH page
            # (unmapped table entries point there, so padding written past
            # a stream's last page never lands on a foreign page); pages
            # are handed out lazily in _ensure_pages. _page_refs counts the
            # owners of each page (fork_stream and the prefix cache alias
            # full pages); a page is free again when its last owner drops it.
            self._free_pages = list(range(self.pool_pages - 1, 0, -1))
            self._table_host = np.zeros((self.N, self._maxp), np.int32)
            self._pages_alloc = [0] * self.N
            self._pos_base_host = np.zeros((self.N,), np.int64)
            self._page_refs = np.zeros((self.pool_pages,), np.int32)
        else:
            self.cache = llama.init_kv_cache(
                self.cfg.llama, batch=self.N, capacity=self.kv_capacity,
                quant=self.kv_quant, device=self.device)
        # prefix cache: start-ids tuple -> {pages, tail_page, length}
        self._prefix_entries: Dict[tuple, Dict[str, Any]] = {}
        self._prefix_hits = 0
        self.frame_queues = [collections.deque() for _ in range(self.N)]
        self.query_queues = [collections.deque() for _ in range(self.N)]
        self.prepends: List[List[int]] = [[] for _ in range(self.N)]
        self._needs_prefill = [True] * self.N
        self.transcripts: List[List[Tuple]] = [[] for _ in range(self.N)]
        self._host_offsets = np.zeros((self.N,), np.int64)
        self._resp_out = [collections.deque() for _ in range(self.N)]
        # spec_decode: per-stream token-history rings, their counts and the
        # accumulated [verify_steps, emitted]
        self._hist = torch.zeros((self.N, gen_mod.SPEC_HIST),
                                 dtype=torch.int32)
        self._hcount = torch.zeros((self.N,), dtype=torch.int32)
        self._sstats = torch.zeros((2,), dtype=torch.int32)
        # "tick": each step(); the phases' spans ("multistream.*") beside it
        self._tick_hist = LatencyHistogram(max_samples=4096)
        self._span = self._tick_hist.measure
        # respond programs and their decode (or verify) forwards: rows fed
        # (N a forward) and rows of streams not yet done
        self._counters = dict.fromkeys(
            ("respond_programs", "decode_forwards", "decode_rows",
             "decode_rows_valid"), 0)
        # the greedy decode forward's CUDA graph (_decode_graph), captured
        # at its first use
        self._graph = llama.DecodeGraph(post=_greedy_ids)
        self._dropped = [0] * self.N
        # response latency: wall clock from the arrival of a response's
        # trigger (the frame's input_frames / the query's input_query call)
        # to the response surfacing; keys ("f" | "q", video_time)
        self._resp_hist = LatencyHistogram(max_samples=4096)
        self._arrival: List[collections.OrderedDict] = [
            collections.OrderedDict() for _ in range(self.N)]
        # stream_tokens: each stream's open response, or None
        self._open: List[Optional[Dict[str, Any]]] = [None] * self.N
        # pipelined: ticks dispatched whose gates are not read yet, oldest
        # first, and the drivers' counts (dispatch_stats)
        self._pipe: collections.deque = collections.deque()
        self._counts = DispatchCounts()

    def _set_table(self):
        self.cache = self.cache.replace(
            table=torch.from_numpy(self._table_host.copy()))

    # ------------------------------------------------------------------ I/O
    def input_frames(self, stream: int, video_time: float,
                     features: np.ndarray):
        """Enqueue frames for one stream, timestamped from ``video_time`` on
        the fps grid: pre-extracted features ((T, fnt, vision_hidden) or
        (T, vision_hidden)), projected on the device at once, or, with
        ``vision_params``, raw uint8 pixels ((T, 3, H, W)) encoded through
        the tower and the connector, ENCODE_FRAMES frames a batch."""
        with self._span("multistream.input"):
            feats = np.asarray(features)
            embeds = None
            if feats.dtype == np.uint8:
                if self.vision_params is None:
                    raise ValueError("raw pixel input needs vision_params")
                if len(feats):
                    px = torch.from_numpy(np.ascontiguousarray(feats)).to(
                        self.device)
                    embeds = torch.cat([
                        live.pixels_to_embeds(
                            self.vision_params, self.params,
                            px[i:i + ENCODE_FRAMES], self.cfg)
                        for i in range(0, len(px), ENCODE_FRAMES)])
            elif len(feats):
                if feats.ndim == 2:
                    feats = feats[:, None, :]
                x = torch.from_numpy(np.ascontiguousarray(feats)).to(
                    self.device)
                embeds = live.visual_embed(self.params, x, self.cfg).reshape(
                    -1, self.fnt, self.hidden)
            now = _time.perf_counter()
            for i in range(len(feats)):
                t = video_time + i / self.frame_fps
                self.frame_queues[stream].append((t, (embeds, i)))
                self._note_arrival(stream, ("f", t), now)

    def input_query(self, stream: int, query: str, video_time: float):
        with self._span("multistream.input"):
            self.query_queues[stream].append((video_time, query))
            self._note_arrival(stream, ("q", video_time), _time.perf_counter())

    def _note_arrival(self, i: int, key, now: float):
        d = self._arrival[i]
        d[key] = now
        if len(d) > 8192:          # bound host memory on long streams
            d.popitem(last=False)

    def _record_response_latency(self, i: int, kind: str, t):
        arr = self._arrival[i].pop((kind, t), None)
        if arr is not None:
            dt = _time.perf_counter() - arr
            self._resp_hist.add("response", dt)
            self._resp_hist.add(f"response_s{i}", dt)

    # ---------------------------------------- token-streaming segments
    def _begin_open(self, i: int, kind: str, t, q: Optional[str]):
        """Open a segmented response for stream ``i``; while it is open the
        stream ingests nothing, as the unsegmented response's KV precedes
        any later frame."""
        assert self._open[i] is None, f"stream {i} already open"
        self._open[i] = {"toks": [], "kind": kind, "t": t, "q": q,
                         "surfaced": "", "ttft_done": False}

    def _extend_open(self, i: int, toks: np.ndarray) -> bool:
        """Absorb one decoded segment: surface its text and finish when the
        segment ended short (EOS), ended on EOS or used up the budget.
        Returns True when the response completed."""
        o = self._open[i]
        o["toks"].extend(int(x) for x in np.asarray(toks).tolist())
        done = (toks.size == 0
                or len(o["toks"]) >= self.resp_budget
                or int(toks.size) < self.max_new
                or int(toks[-1]) == self.cfg.eos_token_id)
        self._emit_delta(i, done)
        if done:
            self._finish_open(i)
        return done

    def _emit_delta(self, i: int, done: bool):
        """One segment surfaced: decode the ids so far and emit the new
        suffix of the text, even when empty (the first call is the time to
        first text, recorded as "ttft" / "ttft_s<i>")."""
        o = self._open[i]
        text = self.tokenizer.decode(np.asarray(o["toks"], np.int32),
                                     skip_special_tokens=True)
        delta = text[len(o["surfaced"]):]
        o["surfaced"] = text
        if not o["ttft_done"]:
            o["ttft_done"] = True
            arr = self._arrival[i].get((o["kind"], o["t"]))
            if arr is not None:
                dt = _time.perf_counter() - arr
                self._resp_hist.add("ttft", dt)
                self._resp_hist.add(f"ttft_s{i}", dt)
        if self.on_delta is not None:
            self.on_delta(i, delta, done)

    def _finish_open(self, i: int):
        """Close stream ``i``'s response: the post-response prepend, the
        transcript entry (the unsegmented engine's) and its latency."""
        o = self._open[i]
        self._open[i] = None
        toks = o["toks"]
        if toks and toks[-1] == self.cfg.eos_token_id:
            self.prepends[i] = [toks[-1]] + self._stream_prompt_ids
        elif toks:
            self.prepends[i] = [toks[-1]]
        t = o["t"]
        q_str = (f"(Video Time = {t}s) User: {o['q']}" if o["kind"] == "q"
                 else None)
        entry = (q_str, f"(Video Time = {t}s) Assistant:{o['surfaced']}")
        self._record_response_latency(i, o["kind"], t)
        self._resp_out[i].append(entry)
        self.transcripts[i].append(entry)

    def _respond_segments(self):
        """One batched continuation segment over every open response: each
        stream's 1-token prompt is its last sampled token (what the
        unsegmented decode feeds), kept out of its history ring. The tick
        that opened a response reserved its whole budget, so no capacity
        guard runs here."""
        mask = np.array([o is not None for o in self._open], bool)
        if not mask.any():
            return
        with self._span("multistream.respond"):
            ids = np.zeros((self.N, TEXT_BUCKET), np.int64)
            nv = np.zeros((self.N,), np.int64)
            for i in np.flatnonzero(mask):
                ids[i, -1] = self._open[i]["toks"][-1]
                nv[i] = 1
            out, lengths = self._respond(ids, nv, mask,
                                         hist_nv=np.zeros((self.N,), np.int64))
            self._sync_offsets()
            for i in np.flatnonzero(mask):
                self._extend_open(i, out[i, :lengths[i]].astype(np.int32))

    def _finish_open_responses(self, streams=None):
        """Run continuation segments until no response of ``streams`` (every
        stream by default) is open."""
        streams = range(self.N) if streams is None else streams
        while any(self._open[i] is not None for i in streams):
            self._respond_segments()

    def dispatch_stats(self) -> Dict[str, Any]:
        """``DispatchCounts`` since ``reset``: a dispatch is a tick, a
        rollback one stream's share of a tick."""
        return self._counts.as_dict()

    def spec_stats(self) -> np.ndarray:
        """[verify_steps, emitted_tokens] accumulated across all streams'
        spec_decode responses. Mean accepted drafts per step =
        tokens / steps - 1."""
        return self._sstats.numpy().copy()

    def maybe_backoff_spec(self, *, min_tokens_per_step: float = 1.15,
                           min_steps: int = 64) -> bool:
        """Turn spec decode off when the measured acceptance across all
        streams makes drafting a net loss. Returns True when it did."""
        if not self.spec_decode:
            return False
        steps, emitted = (int(x) for x in self.spec_stats())
        if steps < min_steps or emitted >= min_tokens_per_step * steps:
            return False
        self._resolve_all()
        self.spec_decode = False
        return True

    def swap_params(self, params):
        """Swap the model weights for every stream (same tree, shapes and
        dtypes). In-flight ticks resolve first, so no tick mixes two weight
        sets. The prefix cache's KV was computed under the old weights and
        is dropped."""
        _check_same_tree(self.params, params)
        self._resolve_all()
        # open segmented responses finish under the old weights
        self._finish_open_responses()
        self._clear_prefix_cache()
        self.params = params
        self._graph.drop()

    def _shed_lag(self):
        """Drop each lagging stream's OLDEST queued frames down to
        ``max_lag_frames``."""
        lag = self.max_lag_frames
        if lag is None:
            return
        for i in range(self.N):
            q = self.frame_queues[i]
            while len(q) > lag:
                q.popleft()
                self._dropped[i] += 1

    def counters(self) -> Dict[str, int]:
        """Since ``reset``: respond programs, their decode (greedy) or
        verify (spec) forwards, the batch rows those fed (N each) and the
        rows of streams not yet done; of the greedy decode forwards, those
        that captured the CUDA graph and those that replayed it."""
        return dict(self._counters,
                    decode_graph_captures=self._graph.captures,
                    decode_graph_replays=self._graph.replays)

    def stats(self) -> Dict[str, Any]:
        """Serving snapshot from host state alone: per-stream queue and cache
        occupancy and drops, pool accounting (paged) with the allocator's
        conservation invariants asserted, tick and response latency
        percentiles, each phase's span percentiles (``phases``, keyed by
        span name) and ``counters()``."""
        phases = self._tick_hist.summary()
        ticks = phases.pop("tick", {})
        out = {
            "streams": [{
                "offset": int(self._host_offsets[i]),
                "queued_frames": len(self.frame_queues[i]),
                "queued_queries": len(self.query_queues[i]),
                "pending_responses": len(self._resp_out[i]),
                "transcript_len": len(self.transcripts[i]),
                "dropped_frames": self._dropped[i],
            } for i in range(self.N)],
            "ticks": ticks,
            "phases": phases,
            "counters": self.counters(),
            "response_latency": self._resp_hist.summary(),
            "open_responses": sum(o is not None for o in self._open),
            "inflight_dispatches": len(self._pipe),
        }
        if self.paged:
            tmpl_refs = self._template_refs()
            # unique physical pages with a ref (an aliased page counts once)
            in_use = int(np.count_nonzero(self._page_refs[1:]))
            # pages whose only refs are template refs
            prefix_owned = int(np.count_nonzero(
                (self._page_refs > 0) & (self._page_refs == tmpl_refs)))
            # (1) a page is free XOR referenced; (2) every ref is owned by
            # exactly one table entry or one template entry
            free_set = set(self._free_pages)
            assert len(free_set) == len(self._free_pages), \
                "free list holds duplicates"
            assert in_use + len(free_set) == self.pool_pages - 1, (
                f"page leak: {in_use} in use + {len(free_set)} free "
                f"!= {self.pool_pages - 1} pool pages")
            for p in free_set:
                assert self._page_refs[p] == 0, \
                    f"page {p} free with refcount {self._page_refs[p]}"
            assert int(self._page_refs.sum()) == \
                sum(self._pages_alloc) + int(tmpl_refs.sum()), (
                "dangling refs: refcounts != table entries + template refs")
            out["pool"] = {
                "pages_total": self.pool_pages - 1,
                "pages_free": len(self._free_pages),
                "pages_in_use": in_use,
                "pages_per_stream": list(self._pages_alloc),
                "page_size": self.page_size,
                "prefix_entries": len(self._prefix_entries),
                "prefix_hits": self._prefix_hits,
                "prefix_owned_pages": prefix_owned,
                "prefix_tail_pages": sum(
                    1 for e in self._prefix_entries.values()
                    if e["tail_page"] is not None),
            }
        return out

    def _template_refs(self) -> np.ndarray:
        """Per-page count of refs held by prefix templates (one per full
        page of an entry and one on its copied tail)."""
        refs = np.zeros((self.pool_pages,), np.int32)
        for e in self._prefix_entries.values():
            for p in e["pages"]:
                refs[p] += 1
            if e["tail_page"] is not None:
                refs[e["tail_page"]] += 1
        return refs

    def _gather_chunks(self, bursts, active, K: int) -> torch.Tensor:
        """(N, K, fnt, D) chunk operand, zero past each burst: one slice of
        the source for a contiguous run of one clip's frames, else one row
        per frame."""
        frames = torch.zeros((self.N, K, self.fnt, self.hidden),
                             dtype=self._frame_dtype(bursts),
                             device=self.device)
        for i in range(self.N):
            if not active[i]:
                continue
            refs = [r for _, r in bursts[i]]
            src, i0 = refs[0]
            if all(s is src and j == i0 + n for n, (s, j) in enumerate(refs)):
                frames[i, :len(refs)] = src[i0:i0 + len(refs)]
            else:
                frames[i, :len(refs)] = torch.stack([s[j] for s, j in refs])
        return frames

    def _frame_dtype(self, bursts):
        for b in bursts:
            if b:
                return b[0][1][0].dtype
        return torch.float32

    # -------------------------------------------------------- page allocator
    def _ensure_pages(self, idxs, budget: int, ahead=None) -> bool:
        """Map enough pool pages that each stream in ``idxs`` can append
        ``budget`` more tokens past its host offset and its ``ahead``
        tokens in flight. Returns False when the pool runs dry."""
        if not self.paged:
            return True
        changed = False
        for i in idxs:
            off = int(self._host_offsets[i]) + (
                0 if ahead is None else int(ahead[i]))
            need = min(self._maxp, -(-(off + budget) // self.page_size))
            while self._pages_alloc[i] < need:
                if not self._free_pages:
                    if changed:
                        self._set_table()
                    return False
                p = self._free_pages.pop()
                self._page_refs[p] = 1
                self._table_host[i, self._pages_alloc[i]] = p
                self._pages_alloc[i] += 1
                changed = True
        if changed:
            self._set_table()
        return True

    def _compact_paged(self):
        """Page-granular window compaction: free every page wholly outside
        the attention window (the window mask defines the semantics, so
        transcripts equal the ring's slot-granular compaction). No device
        data moves: only the table, offsets and pos_base change."""
        assert not self._pipe, "compaction with ticks in flight"
        w = self.stream_window
        if w is None:
            return
        changed = False
        for i in range(self.N):
            off = int(self._host_offsets[i])
            d = (off - w) // self.page_size if off > w else 0
            d = min(d, self._pages_alloc[i])
            if d <= 0:
                continue
            for j in range(d):
                self._unref_page(int(self._table_host[i, j]))
            na = self._pages_alloc[i]
            self._table_host[i, :na - d] = self._table_host[i, d:na]
            self._table_host[i, na - d:] = 0
            self._pages_alloc[i] = na - d
            self._host_offsets[i] -= d * self.page_size
            self._pos_base_host[i] += d * self.page_size
            changed = True
        if changed:
            self._set_table()
            self.cache = self.cache.replace(
                offset=torch.from_numpy(self._host_offsets.astype(np.int32)),
                pos_base=torch.from_numpy(
                    self._pos_base_host.astype(np.int32)))

    def _paged_admit(self, idxs, budget: int, ahead=None) -> bool:
        """Capacity pipeline for one dispatch in paged mode: the per-stream
        logical guard, page-granular compaction, page allocation, and the
        prefix cache's eviction under pool pressure. ``ahead``: per stream,
        the tokens of its ticks in flight, past its host offset (the
        pipelined fill's). Returns False when the dispatch cannot
        proceed."""
        if not self.paged:
            return True

        with self._span("multistream.pages"):
            def over():
                return [i for i in idxs if int(self._host_offsets[i]) + budget
                        + (0 if ahead is None else int(ahead[i]))
                        > self.kv_capacity]

            # in-flight ticks append through the current table: no compaction
            # while one is in flight
            if (over() or not self._ensure_pages(idxs, budget, ahead)) \
                    and not self._pipe:
                self._compact_paged()
            if not over() and not self._ensure_pages(idxs, budget, ahead) \
                    and self._prefix_entries:
                # frees every page whose sole owner is a template; no stream
                # table references any of them
                self._clear_prefix_cache()
            return not over() and self._ensure_pages(idxs, budget, ahead)

    # ------------------------------------------------------------------ tick
    def _prefill_starts(self):
        """System-prompt prefill for the streams that still need it, batched.
        With ``prefix_cache`` the first admission prefills and snapshots its
        KV pages as a template; later admissions alias the template's full
        pages (refcounted) and copy its one partial tail page instead of
        running the prefill forward."""
        todo = [i for i in range(self.N) if self._needs_prefill[i]
                and self.frame_queues[i]]
        if not todo:
            return
        # an admission writes through the table and the host offsets:
        # in-flight ticks resolve first
        self._resolve_all()
        with self._span("multistream.admit"):
            key = tuple(self._start_ids)
            if self.prefix_cache:
                ent = self._prefix_entries.get(key)
                if ent is not None and self._admit_from_prefix(todo, ent):
                    self._prefix_hits += len(todo)
                    return
            P = -(-len(self._start_ids) // PROMPT_BUCKET) * PROMPT_BUCKET
            ids = np.zeros((self.N, P), np.int32)
            nv = np.zeros((self.N,), np.int32)
            for i in todo:
                s = self._start_ids
                ids[i, P - len(s):] = s
                nv[i] = len(s)
                self._needs_prefill[i] = False
                self.prepends[i] = []
                self._host_offsets[i] += len(s)
            active = np.zeros((self.N,), bool)
            active[todo] = True
            # host offsets already include the prefill tokens: budget 0
            if not self._paged_admit(todo, 0):
                raise RuntimeError("paged KV pool exhausted during prefill; "
                                   "raise pool_pages")
            self._prefill(ids, nv, active)
            self._sync_offsets()
            if self.prefix_cache and key not in self._prefix_entries:
                self._build_prefix_template(todo[0], key)

    def _build_prefix_template(self, donor: int, key: tuple) -> None:
        """Snapshot the just-prefilled ``donor``'s pages as the prefix
        template: full pages aliased, the partial tail page copied into a
        template-owned page now, before the donor's next append writes into
        it. Skipped when the pool has no spare page."""
        S = len(self._start_ids)
        full, r = divmod(S, self.page_size)
        tail = None
        if r:
            if not self._free_pages:
                return
            tail = self._free_pages.pop()
            self._page_refs[tail] = 1
            self._copy_page(tail, int(self._table_host[donor, full]))
        pages = [int(self._table_host[donor, j]) for j in range(full)]
        for p in pages:
            self._page_refs[p] += 1
        self._prefix_entries[key] = {
            "pages": pages, "tail_page": tail, "length": S}

    def _admit_from_prefix(self, todo, ent) -> bool:
        """Admit ``todo`` fresh slots by aliasing the cached prefix pages
        (refcounts bumped) and giving each a private copy of the template's
        tail page. Returns False, for a normal prefill, when the pool cannot
        cover the tail pages."""
        with self._span("multistream.pages"):
            S = ent["length"]
            if ent["tail_page"] is not None \
                    and len(self._free_pages) < len(todo):
                self._compact_paged()
                if len(self._free_pages) < len(todo):
                    return False
            dsts = []
            for i in todo:
                for j, p in enumerate(ent["pages"]):
                    self._page_refs[p] += 1
                    self._table_host[i, j] = p
                alloc = len(ent["pages"])
                if ent["tail_page"] is not None:
                    p_new = self._free_pages.pop()
                    self._page_refs[p_new] = 1
                    self._table_host[i, alloc] = p_new
                    dsts.append(p_new)
                    alloc += 1
                self._pages_alloc[i] = alloc
                self._host_offsets[i] = S
                self._pos_base_host[i] = 0
                self._needs_prefill[i] = False
                self.prepends[i] = []
            self._set_table()
            if dsts:
                self._copy_page_multi(ent["tail_page"], dsts)
            mask = np.zeros((self.N,), bool)
            mask[todo] = True
            self._mask_set_offsets(mask, np.full((self.N,), S, np.int32))
            return True

    def _clear_prefix_cache(self):
        for ent in self._prefix_entries.values():
            for p in ent["pages"]:
                self._unref_page(p)
            if ent["tail_page"] is not None:
                self._unref_page(ent["tail_page"])
        self._prefix_entries = {}

    def step(self) -> List[Optional[Tuple[Optional[str], str]]]:
        """One scheduler tick: ingest up to ``chunk_frames`` queued frames
        per stream in one batched forward (gated at every frame), then
        answer every stream whose gate fired or whose query came due in a
        second batched program; with ``pipelined`` the ingest of later
        ticks is dispatched before this one's gates are read. Returns per
        stream (query, response) or None; responses beyond one per stream
        per call surface on later calls (FIFO)."""
        self._shed_lag()
        t0 = _time.perf_counter()
        try:
            if self.pipelined:
                return self._step_pipe()
            if self.stream_tokens:
                # one continuation segment for every open response, before
                # the other streams' ingest
                self._respond_segments()
            return self._step_unfused()
        finally:
            self._tick_hist.add("tick", _time.perf_counter() - t0)

    def _collect_ingest(self) -> Optional[Dict[str, Any]]:
        """A tick's ingest from the queues: per stream, up to
        ``chunk_frames`` queued frames up to its next query's time (none
        for a stream that still needs its prefill, has a response open or
        has a query due before its next frame), its prepend (taken at
        dispatch), and the ring slots the tick reserves a stream: the
        chunk write as a full static-size slab, a prompt bucket and the
        whole response budget (segmented responses reserve it here too).
        None when no stream has a frame to ingest."""
        K, N = self.chunk_frames, self.N
        text_ids = np.zeros((N, TEXT_BUCKET), np.int32)
        n_text = np.zeros((N,), np.int32)
        bursts: List[List[Tuple[float, Any]]] = [[] for _ in range(N)]
        active = np.zeros((N,), bool)
        for i in range(N):
            if (not self.frame_queues[i] or self._needs_prefill[i]
                    or self._open[i] is not None):
                continue
            # a queued query earlier than the next frame answers first
            qq = self.query_queues[i]
            if qq and self.frame_queues[i][0][0] > qq[0][0]:
                continue
            qt = qq[0][0] if qq else None
            for t, emb in self.frame_queues[i]:
                if len(bursts[i]) >= K or (qt is not None and t > qt):
                    break
                bursts[i].append((t, emb))
            if not bursts[i]:
                continue
            pre = self.prepends[i][-TEXT_BUCKET:]
            if pre:
                text_ids[i, TEXT_BUCKET - len(pre):] = pre
            n_text[i] = len(pre)
            active[i] = True
        if not active.any():
            return None
        max_burst = max(len(b) for b in bursts)
        itv = 1 if self.cfg.frame_token_interval_id is not None else 0
        write_len = (TEXT_BUCKET + self.fnt if max_burst <= 1 else
                     TEXT_BUCKET + K * self.fnt + (K - 1) * itv)
        return {"bursts": bursts, "active": active, "text_ids": text_ids,
                "n_text": n_text, "max_burst": max_burst,
                "budget": write_len + PROMPT_BUCKET + self.resp_budget}

    def _admit_tick(self, coll):
        """The blocking tick's capacity guard: pages (paged) or the ring's
        room for every active stream, compacting past ``stream_window``
        where that makes room; raises when it cannot."""
        N, budget = self.N, coll["budget"]
        active = coll["active"]
        if self.paged:
            idxs = [i for i in range(N) if active[i]]
            if not self._paged_admit(idxs, budget):
                raise RuntimeError(
                    f"streams {idxs}: paged KV pool/logical capacity "
                    f"exceeded (offsets "
                    f"{[int(self._host_offsets[i]) for i in idxs]}, "
                    f"budget {budget}); raise kv_capacity/pool_pages or "
                    f"set stream_window")
            return
        over = [i for i in range(N) if active[i]
                and int(self._host_offsets[i]) + budget > self.kv_capacity]
        if over and self.stream_window is not None:
            # compact every stream past its window (streams at or under
            # the window are untouched: keep = min(window, offset))
            self.cache = llama.compact_kv_cache(self.cache,
                                                self.stream_window)
            self._host_offsets = np.minimum(self._host_offsets,
                                            self.stream_window)
            over = [i for i in over
                    if int(self._host_offsets[i]) + budget > self.kv_capacity]
        for i in over:
            raise RuntimeError(
                f"stream {i}: KV ring capacity {self.kv_capacity} "
                f"would be exceeded (offset "
                f"{int(self._host_offsets[i])}); raise kv_capacity or "
                f"set stream_window")

    def _step_unfused(self) -> List[Optional[Tuple[Optional[str], str]]]:
        self._prefill_starts()
        N = self.N
        with self._span("multistream.admit"):
            coll = self._collect_ingest()
            if coll is not None:
                self._admit_tick(coll)
        if coll is not None:
            with self._span("multistream.ingest"):
                e = self._dispatch_ingest(coll)
        with self._span("multistream.settle"):
            active = np.zeros((N,), bool)
            fire = np.zeros((N,), bool)
            next_id = np.zeros((N,), np.int64)
            consumed = np.zeros((N,), np.int64)
            frame_times = [None] * N
            if coll is not None:
                consumed, fire, next_id, tokens = self._settle_ingest(e)
                active = coll["active"]
                # each stream's offset at the end of its consumed frames
                self.cache = self.cache.replace(offset=torch.as_tensor(
                    e["base"] + tokens, dtype=torch.int32))
                self._sync_offsets()
                # pop consumed frames; record each stream's last processed
                # time
                for i in range(N):
                    c = int(consumed[i])
                    for _ in range(c):
                        self.frame_queues[i].popleft()
                    if c:
                        frame_times[i] = coll["bursts"][i][c - 1][0]
            due = self._schedule(active, consumed, fire, next_id, frame_times)
        results = self._respond_turn(*due, frame_times)
        # surface queued entries FIFO; this tick's result queues behind them
        for i in range(N):
            if self._resp_out[i]:
                if results[i] is not None:
                    self._resp_out[i].append(results[i])
                results[i] = self._resp_out[i].popleft()
        return results

    def _schedule(self, active, consumed, fire, next_id, frame_times,
                  in_newer=None):
        """After a tick's gates are read: the prepends of the streams that
        went on, and which streams answer now: a fired stream (its query
        instead when that query's time is the fired frame's), and a stream
        whose query came due: the frame just processed reaches the query
        time, or its next frame is strictly later (a frame in a newer
        dispatch, ``in_newer``, counts as next). Returns (respond_mask,
        respond_query)."""
        N = self.N
        respond_mask = np.zeros((N,), bool)
        respond_query: List[Optional[Tuple[float, str]]] = [None] * N
        for i in range(N):
            if active[i] and consumed[i] and not fire[i]:
                if self.cfg.frame_token_interval_id is not None:
                    self.prepends[i] = [int(next_id[i])]
            if fire[i]:
                # a query at the fired frame's timestamp outranks the gate
                qq = self.query_queues[i]
                if qq and frame_times[i] is not None \
                        and frame_times[i] >= qq[0][0]:
                    respond_query[i] = qq.popleft()
                respond_mask[i] = True
                self.prepends[i] = []
            # answer a query once the stream has caught up to it. A fired
            # stream's query waits a tick.
            qq = self.query_queues[i]
            next_later = (not (in_newer is not None and in_newer[i])
                          and self.frame_queues[i]
                          and self.frame_queues[i][0][0] > qq[0][0]
                          if qq else False)
            if not fire[i] and qq and not self._needs_prefill[i] \
                    and self._open[i] is None and (
                    (frame_times[i] is not None and frame_times[i] >= qq[0][0])
                    or next_later):
                respond_query[i] = qq.popleft()
                respond_mask[i] = True
        return respond_mask, respond_query

    def _respond_turn(self, respond_mask, respond_query, frame_times
                      ) -> List[Optional[Tuple[Optional[str], str]]]:
        """One batched respond program for the streams of ``respond_mask``
        (a query prompt where ``respond_query`` names one, the stream
        prompt after a gate fire). Returns per stream its (query,
        response), or None (also while a segmented response stays open)."""
        N = self.N
        results: List[Optional[Tuple[Optional[str], str]]] = [None] * N
        if not respond_mask.any():
            return results
        with self._span("multistream.respond"):
            prompts: Dict[int, List[int]] = {}
            for i in range(N):
                if not respond_mask[i]:
                    continue
                if respond_query[i] is not None:
                    prompts[i] = list(self.tokenizer.apply_chat_template(
                        [{"role": "user", "content": respond_query[i][1]}],
                        tokenize=True, add_stream_query_prompt=True,
                        add_generation_prompt=True))
                    self.prepends[i] = []
                else:
                    prompts[i] = self._gen_prompt_ids
            longest = max(len(p) for p in prompts.values())
            P = -(-max(longest, 1) // PROMPT_BUCKET) * PROMPT_BUCKET
            ids = np.zeros((N, P), np.int64)
            nv = np.zeros((N,), np.int64)
            for i, prompt in prompts.items():
                ids[i, P - len(prompt):] = prompt
                nv[i] = len(prompt)
            out, lengths = self._respond(ids, nv, respond_mask)
            self._sync_offsets(respond_mask)
            for i in range(N):
                if not respond_mask[i]:
                    continue
                toks = out[i, :lengths[i]]
                t = (respond_query[i][0] if respond_query[i] is not None
                     else frame_times[i])
                if self.stream_tokens:
                    # the first segment opens the response; a completed one
                    # lands in _resp_out and surfaces this tick
                    query = respond_query[i]
                    self._begin_open(i, "q" if query is not None else "f", t,
                                     query[1] if query is not None else None)
                    self._extend_open(i, toks.astype(np.int32))
                    continue
                if toks.size and toks[-1] == self.cfg.eos_token_id:
                    self.prepends[i] = ([int(toks[-1])]
                                        + self._stream_prompt_ids)
                elif toks.size:
                    self.prepends[i] = [int(toks[-1])]
                resp = self.tokenizer.decode(toks.astype(np.int32),
                                             skip_special_tokens=True)
                q_str = (f"(Video Time = {t}s) User: {respond_query[i][1]}"
                         if respond_query[i] is not None else None)
                results[i] = (q_str, f"(Video Time = {t}s) Assistant:{resp}")
                self._record_response_latency(
                    i, "q" if respond_query[i] is not None else "f", t)
                self.transcripts[i].append(results[i])
        return results

    # ------------------------------------------------------ pipelined mode
    def _step_pipe(self) -> List[Optional[Tuple[Optional[str], str]]]:
        self._prefill_starts()
        while len(self._pipe) >= self.pipeline_depth:
            self._pipe_resolve()
        blocked, added = self._pipe_fill()
        if blocked:
            # resolve what is in flight, then one blocking tick (its guard
            # compacts or raises), so a tight ring still makes progress
            self._resolve_all()
            return self._step_unfused()
        if not self._pipe:
            # nothing to dispatch: a blocking tick answers what is due
            return self._step_unfused()
        if not added:
            # every stream waits on the oldest tick, a gate or a query
            # turn: resolve it, then send the next tick out behind it
            self._pipe_resolve()
            self._pipe_fill()
        return self._drain_out()

    def _drain_out(self):
        return [self._resp_out[i].popleft() if self._resp_out[i] else None
                for i in range(self.N)]

    def _pipe_fill(self) -> Tuple[bool, int]:
        """Dispatch ticks up to the pipeline depth, each stream assuming its
        gates in the ticks before hold (frames popped, the interval token as
        its next prepend). The ring, or the pages, must hold every in-flight
        tick's worst case before another is dispatched; no compaction runs
        while a tick is in flight. Returns (blocked by that guard, ticks
        dispatched)."""
        iv = self.cfg.frame_token_interval_id
        added = 0
        while len(self._pipe) < self.pipeline_depth:
            with self._span("multistream.admit"):
                coll = self._collect_ingest()
                if coll is None:
                    return False, added
                idxs = [int(i) for i in np.flatnonzero(coll["active"])]
                # each stream's tokens in flight: the tick is admitted from
                # the offset its stream would have if no gate in flight
                # fires, as the blocking tick would admit it there
                ahead = (self.cache.offset.numpy().astype(np.int64)
                         - self._host_offsets)
                if any(int(self._host_offsets[i] + ahead[i]) + coll["budget"]
                       > self.kv_capacity for i in idxs):
                    return True, added
                before = list(self._pages_alloc) if self.paged else None
                if self.paged and not self._paged_admit(idxs, coll["budget"],
                                                        ahead):
                    return True, added
            with self._span("multistream.ingest"):
                e = self._dispatch_ingest(coll)
                # the pages this tick's admission mapped, freed again if
                # its stream's work here is rolled back
                e["pages"] = ({i: before[i] for i in idxs} if self.paged
                              else {})
                for i in idxs:
                    for _ in coll["bursts"][i]:
                        self.frame_queues[i].popleft()
                    self.prepends[i] = [iv] if iv is not None else []
                self._pipe.append(e)
            added += 1
            self._counts.inflight(len(self._pipe))
        return False, added

    def _pipe_resolve(self):
        """Resolve the oldest in-flight tick: each stream's resolved offset;
        a stream whose gate fired gets its frames in newer ticks and its
        unconsumed frames here re-queued and its ring offset rewound (the
        stale slots past it are never attended), while the other streams
        keep their work; then one respond program for the streams that
        answer now. Their responses queue in ``_resp_out``."""
        N = self.N
        with self._span("multistream.settle"):
            e = self._pipe.popleft()
            coll = e["coll"]
            consumed, fire, next_id, tokens = self._settle_ingest(e)
            frame_times = [None] * N
            for i in np.flatnonzero(coll["active"]):
                self._host_offsets[i] = e["base"][i] + tokens[i]
                if consumed[i]:
                    frame_times[i] = coll["bursts"][i][consumed[i] - 1][0]
            for i in np.flatnonzero(fire):
                for newer in reversed(self._pipe):
                    nc = newer["coll"]
                    if nc["active"][i]:
                        self.frame_queues[i].extendleft(
                            reversed(nc["bursts"][i]))
                        nc["active"][i] = False
                        if self.paged:
                            self._unmap_tail(i, newer["pages"][i])
                        self._counts.rolled_back(len(nc["bursts"][i]))
                self.frame_queues[i].extendleft(
                    reversed(coll["bursts"][i][consumed[i]:]))
            if fire.any():
                offs = self.cache.offset.clone()
                offs[fire] = torch.as_tensor(self._host_offsets[fire],
                                             dtype=torch.int32)
                self.cache = self.cache.replace(offset=offs)
            in_newer = [any(n["coll"]["active"][i] for n in self._pipe)
                        for i in range(N)]
            due = self._schedule(coll["active"], consumed, fire, next_id,
                                 frame_times, in_newer)
        results = self._respond_turn(*due, frame_times)
        for i, r in enumerate(results):
            if r is not None:
                self._resp_out[i].append(r)

    def _unmap_tail(self, i: int, keep: int):
        """Drop stream ``i``'s page-table entries past its first ``keep``
        (pages a rolled-back tick mapped; the work in flight that writes
        them comes first on the stream, so a page's next owner overwrites
        it)."""
        with self._span("multistream.pages"):
            while self._pages_alloc[i] > keep:
                self._pages_alloc[i] -= 1
                j = self._pages_alloc[i]
                self._unref_page(int(self._table_host[i, j]))
                self._table_host[i, j] = 0
            self._set_table()

    def _resolve_all(self):
        while self._pipe:
            self._pipe_resolve()

    def flush(self) -> List[List[Tuple[Optional[str], str]]]:
        """Resolve every in-flight tick, finish every open segmented
        response and drain every queued response; returns them per
        stream."""
        self._resolve_all()
        self._finish_open_responses()
        out = [list(self._resp_out[i]) for i in range(self.N)]
        for i in range(self.N):
            self._resp_out[i].clear()
        return out

    def pending(self) -> bool:
        return (any(q for q in self.frame_queues)
                or any(q for q in self.query_queues)
                or any(q for q in self._resp_out)
                or any(o is not None for o in self._open)
                or bool(self._pipe))

    def close_stream(self, i: int) -> List[Tuple[Optional[str], str]]:
        """End stream ``i``'s dialogue and return its transcript. The slot
        serves a NEW dialogue at once (the next ``input_frames(i, ...)``
        prefills the system prompt again, or admits it from the prefix
        cache); in paged mode its pages return to the pool now. Sibling
        streams are untouched."""
        # in-flight ticks resolve first; an open segmented response
        # belongs to this dialogue: finish it
        self._resolve_all()
        self._finish_open_responses([i])
        with self._span("multistream.close"):
            out = self.transcripts[i]
            self.transcripts[i] = []
            self.frame_queues[i].clear()
            self.query_queues[i].clear()
            self.prepends[i] = []
            self._resp_out[i].clear()
            self._needs_prefill[i] = True
            self._host_offsets[i] = 0
            if self.paged:
                with self._span("multistream.pages"):
                    for j in range(self._pages_alloc[i]):
                        self._unref_page(int(self._table_host[i, j]))
                    self._table_host[i] = 0
                    self._pages_alloc[i] = 0
                    self._pos_base_host[i] = 0
                    self._set_table()
            off = self.cache.offset.clone()
            pb = self.cache.pos_base.clone()
            off[i] = 0
            pb[i] = 0
            self.cache = self.cache.replace(offset=off, pos_base=pb)
            # spec-decode history and drop stats are per dialogue
            self._hist[i] = 0
            self._hcount[i] = 0
            self._dropped[i] = 0
            self._arrival[i].clear()
            return out

    def _unref_page(self, p: int):
        self._page_refs[p] -= 1
        assert self._page_refs[p] >= 0, f"page {p} over-freed"
        if self._page_refs[p] == 0:
            self._free_pages.append(p)

    def fork_stream(self, src: int, dst: int):
        """Fork dialogue ``src`` into the fresh or closed slot ``dst``
        (paged mode only): ``dst`` continues from the same context. Full
        pages are shared through the table (refcounted, no data moves) and
        only the partial tail page is copied: appends write at slots >=
        offset, in the private tail page or later, so a shared page is
        never written."""
        if not self.paged:
            raise ValueError("fork_stream requires the paged KV layout")
        if src == dst:
            raise ValueError("fork_stream: src == dst")
        # fork a quiescent source: in-flight ticks resolve and its open
        # response finishes first
        self._resolve_all()
        self._finish_open_responses([src])
        if (self._pages_alloc[dst] or self.frame_queues[dst]
                or self.query_queues[dst] or self._resp_out[dst]
                or int(self._host_offsets[dst])):
            raise ValueError("fork target must be a fresh or closed slot")
        off = int(self._host_offsets[src])
        full, r = divmod(off, self.page_size)
        # allocate the tail page before any refcount changes: raising after
        # aliasing would leak the bumped refs
        if r > 0 and not self._free_pages:
            raise RuntimeError("paged KV pool exhausted in fork_stream")
        for j in range(full):
            p = int(self._table_host[src, j])
            self._page_refs[p] += 1
            self._table_host[dst, j] = p
        alloc = full
        if r > 0:
            p_new = self._free_pages.pop()
            self._page_refs[p_new] = 1
            self._copy_page(p_new, int(self._table_host[src, full]))
            self._table_host[dst, full] = p_new
            alloc = full + 1
        self._pages_alloc[dst] = alloc
        self._host_offsets[dst] = off
        self._pos_base_host[dst] = self._pos_base_host[src]
        self._dropped[dst] = 0
        offs = self.cache.offset.clone()
        pbs = self.cache.pos_base.clone()
        offs[dst] = offs[src]
        pbs[dst] = pbs[src]
        self._set_table()
        self.cache = self.cache.replace(offset=offs, pos_base=pbs)
        # conversation state rides along; queues stay empty
        self._needs_prefill[dst] = self._needs_prefill[src]
        self.prepends[dst] = list(self.prepends[src])
        self.transcripts[dst] = list(self.transcripts[src])
        self._hist[dst] = self._hist[src]
        self._hcount[dst] = self._hcount[src]
