"""LiveInferEngine — the single-stream streaming serving loop, in PyTorch.

Counterpart of ``videollm_online_tpu/serve/engine.py``: the same public
API (``load_video`` / ``input_video_stream`` / ``input_query_stream`` /
``__call__`` / ``reset`` / ``stats`` / ``set_threshold`` /
``swap_params`` / ``maybe_backoff_spec`` / ``flush``) and the same
transcripts. Frames are ingested one forward per frame, or
``CHUNK_FRAMES`` frames in one forward when a burst holds several; the
response gate (P(interval) against the threshold) is read at every frame's
last token; a fire rewinds the ring offset to the end of the fired frame.
Responses are greedy, or n-gram speculative when ``spec_decode`` is on (the
same transcripts).

The engine's options are the JAX engine's:
  * raw uint8 frames (T, 3, H, W), or a video file, encoded by the SigLIP
    tower and the connector (``vision_params``), on ``encoder_device`` when
    one is given;
  * ``stream_window``: windowed attention, and the ring compacted to the
    newest window when it would overflow;
  * ``kv_quant="int8"``: the int8 ring, read by K1's int8 form;
  * ``stream_tokens`` / ``on_delta``: responses decoded in segments of S
    tokens, each surfaced through ``on_delta``;
  * ``spec_forced_script``: forced-response replay through the verify path;
  * the dispatch-ahead drivers. ``speculative`` (realtime): frame i + 1 is
    dispatched, with the interval token as its prepend, before frame i's
    gate is read; ``pipelined`` (sustained): burst i + 1 is dispatched
    before burst i's gates are read. Each dispatch's gate ids travel to a
    pinned host buffer of their own (``core.device.DeferredRead``) and are
    read when the driver resolves it; the host keeps the offsets, which
    advance on the guess that no gate fires, and a wrong guess is rolled
    back (frames re-queued, the ring offset rewound). Transcripts are the
    blocking engine's; a response may surface one ``__call__`` later and
    ``flush()`` returns the tail still in flight. Responses run at
    resolution, with nothing in flight.
  * ``fused_respond`` / ``multi_respond`` name the JAX engine's packing of
    ingest and responses into one XLA program (up to ``R_STREAM`` turns a
    dispatch). Eager PyTorch has no such program: both select this
    engine's step, which answers one turn a call, so no response waits in
    a buffer (``stats()["pending_responses"]`` is 0).
The KV ring is updated in place.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import LiveConfig
from ..core.device import DeferredRead, resolve_device, to_device
from ..models import generate as gen_mod
from ..models import live, llama
from ..tokenizer.live_tokenizer import LiveTokenizer

TEXT_BUCKET = 4        # in-burst prepend: '' | ',' | eos + '\n['
PROMPT_BUCKETS = (32, 64, 128, 256)  # prefill / query-response prompts
CHUNK_FRAMES = 8       # frames per chunked-ingest forward


def _pack_valid_first(embeds: torch.Tensor, bucket: int, num_valid: int
                      ) -> torch.Tensor:
    """Right-aligned valid rows -> valid-first rows (circular left roll)."""
    return torch.roll(embeds, -(bucket - num_valid), dims=1)


def _right_aligned(ids, bucket: int) -> torch.Tensor:
    buf = torch.zeros((1, bucket), dtype=torch.int32)
    if len(ids):
        buf[0, bucket - len(ids):] = torch.as_tensor(list(ids),
                                                     dtype=torch.int32)
    return buf


def _check_same_tree(old, new, path="params"):
    """swap_params guard: the same tree with the same leaf shapes and
    dtypes."""
    if isinstance(old, dict):
        if not isinstance(new, dict) or old.keys() != new.keys():
            raise ValueError(f"{path}: tree structure differs")
        for k in old:
            _check_same_tree(old[k], new[k], f"{path}.{k}")
    elif (not isinstance(new, torch.Tensor) or old.shape != new.shape
          or old.dtype != new.dtype):
        raise ValueError(f"{path}: shape or dtype differs")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class DispatchCounts:
    """The dispatch-ahead drivers' counts, shared by both engines: ingest
    forwards dispatched, those rolled back (and their frames), the most in
    flight at once, those resolved, and the host's total wait on their
    readbacks at resolution (seconds)."""

    def __init__(self):
        self._c = {"dispatches": 0, "rolled_back": 0, "rolled_back_frames": 0,
                   "max_inflight": 0, "resolved": 0, "wait_s": 0.0}

    def dispatched(self):
        self._c["dispatches"] += 1

    def inflight(self, n: int):
        self._c["max_inflight"] = max(self._c["max_inflight"], n)

    def rolled_back(self, frames: int):
        self._c["rolled_back"] += 1
        self._c["rolled_back_frames"] += frames

    def read(self, ids: DeferredRead) -> torch.Tensor:
        """Resolve one dispatch: its host ids, the wait counted."""
        out = ids.read()
        self._c["resolved"] += 1
        self._c["wait_s"] += ids.wait_s
        return out

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._c)


@dataclasses.dataclass
class _Inflight:
    """One ingest forward dispatched before its gates were read: its frames
    (times, embeddings), the length of its prepend, the ring offset before
    it, its gate ids on their way to the host, whether a query turn falls
    due at its end (pipelined), and the ring slots it reserves in the
    capacity guard."""
    times: List[float]
    frames: List[torch.Tensor]
    first_n: int
    base: int
    ids: DeferredRead
    qae: bool
    worst: int


class LiveInferEngine:
    def __init__(
        self,
        params: Dict[str, Any],
        tokenizer: LiveTokenizer,
        cfg: Optional[LiveConfig] = None,
        *,
        kv_capacity: int = 16384,
        frame_fps: Optional[float] = None,
        attn_impl=None,
        spec_decode: bool = False,
        spec_draft: Optional[int] = None,
        spec_draft_mode: str = "ngram",
        device=None,
        vision_params=None,
        encoder_device=None,
        stream_window: Optional[int] = None,
        kv_quant: Optional[str] = None,
        stream_tokens: Optional[int] = None,
        fused_respond: bool = True,
        multi_respond: bool = True,
        pipelined: bool = False,
        speculative: bool = False,
        spec_forced_script=None,
        on_delta: Optional[Callable[[str, bool], None]] = None,
    ):
        if pipelined and speculative:
            raise ValueError("pipelined (sustained) and speculative "
                             "(realtime) dispatch exclude each other")
        if stream_tokens is not None and (pipelined or speculative):
            raise ValueError("stream_tokens is a blocking-engine mode (no "
                             "pipelined or speculative dispatch)")
        # fused_respond / multi_respond select this engine's step (module
        # docstring): accepted for the JAX engine's signature, read nowhere
        self.speculative = speculative
        self.pipelined = pipelined
        # depth 2: one unresolved dispatch in flight behind the newest
        self.pipeline_depth = 2
        if spec_draft_mode not in ("ngram", "zero"):
            raise ValueError(f"spec_draft_mode {spec_draft_mode!r}")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant {kv_quant!r}")
        self.device = resolve_device(device)
        self.params = params
        self.tokenizer = tokenizer
        self.cfg = cfg or tokenizer.cfg
        if self.cfg.v_placeholder_id is None:
            raise ValueError("config is missing its tokenizer ids")
        budget = self.cfg.max_response_tokens
        self.spec_decode = spec_decode
        # K = budget - 1 lets one verify step finish a predicted response;
        # capped at 19 for long budgets
        self.spec_draft = int(spec_draft or max(1, min(budget - 1, 19)))
        self.spec_draft_mode = spec_draft_mode
        # forced-response replay: response turn r emits row r % n_rows of
        # the script instead of the argmax, through the same verify
        # forwards (generate.py forced_ids); a bench knob of spec decode
        self._forced_script = None
        if spec_forced_script is not None:
            if not spec_decode:
                raise ValueError("spec_forced_script requires spec_decode")
            if stream_tokens is not None:
                raise ValueError("spec_forced_script and stream_tokens do "
                                 "not combine")
            script = np.asarray(spec_forced_script, np.int32)
            if script.ndim != 2 or script.shape[1] != budget:
                raise ValueError(f"script must be (n_rows, {budget}); got "
                                 f"{script.shape}")
            self._forced_script = script
        self.kv_quant = kv_quant
        # stream_tokens = S: each response is decoded in segments of at
        # most S tokens, each surfaced through on_delta(delta, done); the
        # next segment's 1-token prompt is the last sampled token, so the
        # segments join into the unsegmented response
        self.stream_tokens = stream_tokens
        self.on_delta = on_delta
        if stream_tokens is not None:
            if stream_tokens <= 0 or budget % stream_tokens:
                raise ValueError(
                    f"stream_tokens {stream_tokens} must be positive and "
                    f"divide max_response_tokens {budget}")
            if spec_decode and spec_draft is None:
                # K = S - 1: one verify step can complete a segment
                self.spec_draft = (max(1, min(self.spec_draft,
                                              stream_tokens - 1))
                                   if stream_tokens > 1 else 1)
        self.max_new = stream_tokens or budget
        # infinite streams: attention over the newest stream_window tokens,
        # and the ring compacted to them when it would overflow
        # (transcripts equal to an uncompacted engine with the same window)
        self.stream_window = stream_window
        if stream_window is not None:
            need = (stream_window + TEXT_BUCKET
                    + CHUNK_FRAMES * (self.cfg.frame_num_tokens + 1)
                    + max(PROMPT_BUCKETS) + budget)
            if kv_capacity < need:
                raise ValueError(
                    f"kv_capacity {kv_capacity} too small for stream_window "
                    f"{stream_window}: needs >= {need} (window + one chunk "
                    f"+ one response turn)")
            self.cfg = self.cfg.replace(llama=dataclasses.replace(
                self.cfg.llama, sliding_window=stream_window))
        self.kv_capacity = kv_capacity
        self.frame_fps = frame_fps or self.cfg.frame_fps
        self.frame_num_tokens = self.cfg.frame_num_tokens
        if attn_impl is None:
            from ..ops.auto import auto_attention
            attn_impl = auto_attention
        self.attn_impl = attn_impl
        self.hidden = self.cfg.llama.hidden_size
        lora = params.get("lora")
        self._lora_scaling = (self.cfg.lora.scaling if (
            self.cfg.lora is not None and lora is not None) else 1.0)
        iv = self.cfg.frame_token_interval_id
        self._gate_ref_id = iv if iv is not None else self.cfg.eos_token_id
        # the vision tower and a copy of the connector run on
        # encoder_device (the decoder's device when None); the embeddings
        # then move to the decoder's device
        self.encoder_device = (resolve_device(encoder_device)
                               if encoder_device is not None else self.device)
        self.vision_params = vision_params
        if vision_params is not None:
            self.vision_params = _to_device(vision_params, self.encoder_device)
        self._set_encoder_connector()

        tok = tokenizer
        self._start_ids = np.asarray(tok.apply_chat_template(
            [{"role": "system", "content": self.cfg.system_prompt}],
            tokenize=True, add_stream_prompt=True), np.int32)
        self._stream_prompt_ids = np.asarray(tok.encode("\n["), np.int32)
        self._gen_prompt_ids = list(tok.encode("]\nAssistant:"))
        n_gen = len(self._gen_prompt_ids)
        self._gen_prompt_bucket = next(
            (b for b in PROMPT_BUCKETS if b >= n_gen), n_gen)
        self.reset()

    # ---------------------------------------------------------------- state
    def reset(self):
        self.query_queue = collections.deque()
        self.frame_embeds_queue = collections.deque()
        self.video_time = 0.0
        self.last_frame_idx = -1
        self.video_tensor = None
        self.num_video_frames = 0
        self.cache = llama.init_kv_cache(
            self.cfg.llama, batch=1, capacity=self.kv_capacity,
            quant=self.kv_quant, device=self.device)
        self._started = False
        # pending text prepend (token ids) to feed before the next frame
        self._pending_prepend: List[int] = []
        # dispatched ingest forwards whose gates are not read yet, oldest
        # first (_Inflight): the speculative driver's single frames, or the
        # pipelined driver's bursts
        self._inflight: collections.deque = collections.deque()
        self._pipe_blocked = False
        # frames of the blocking step's burst still to dispatch (pipelined):
        # they go out as chunks, as _ingest_chunks sends them
        self._burst_left = 0
        self._counts = DispatchCounts()
        # spec_decode: token-history ring, its count, [verify_steps,
        # emitted] and, under forced replay, the response turns (the
        # script's cursor)
        self._hist = torch.zeros((gen_mod.SPEC_HIST,), dtype=torch.int32)
        self._hcount = torch.tensor(0, dtype=torch.int32)
        self._sstats = torch.zeros(
            (3 if self._forced_script is not None else 2,), dtype=torch.int32)

    @property
    def _ring_offset(self) -> int:
        """The ring's offset as dispatched: in-flight work included."""
        return int(self.cache.offset[0])

    @property
    def _host_offset(self) -> int:
        """The resolved offset: the ring's, less what is still in flight."""
        return (self._inflight[0].base if self._inflight
                else self._ring_offset)

    # ------------------------------------------------------------------ I/O
    def load_video(self, video: Any):
        """(T, 3, H, W) uint8 frames, (T, vision_hidden) or (T, fnt,
        vision_hidden) pre-extracted features, or a path that
        ``data/video_io.read_video_frames`` reads (a video file, decoded at
        the engine's fps and the config's frame resolution; ``.npy``,
        ``.npz``, ``.pt`` features)."""
        if isinstance(video, str):
            from ..data.video_io import read_video_frames
            video = read_video_frames(video, fps=self.frame_fps,
                                      resolution=self.cfg.frame_resolution)
        video = np.asarray(video)
        self.video_tensor = video
        self.num_video_frames = video.shape[0]
        self.video_duration = video.shape[0] / self.frame_fps

    def spec_stats(self) -> np.ndarray:
        """[verify_steps, emitted_tokens] accumulated by spec_decode
        responses; mean accepted drafts per step = tokens / steps - 1."""
        return self._sstats[:2].numpy().copy()

    def stats(self) -> Dict[str, Any]:
        """Serving snapshot from host state alone: the resolved ring
        occupancy, queue depths and the dispatches in flight. No response
        waits in a buffer here (module docstring)."""
        return {
            "offset": self._host_offset,
            "kv_capacity": self.kv_capacity,
            "queued_frames": len(self.frame_embeds_queue),
            "queued_queries": len(self.query_queue),
            "pending_responses": 0,
            "inflight_speculative": (len(self._inflight)
                                     if self.speculative else 0),
            "inflight_pipelined": (len(self._inflight)
                                   if self.pipelined else 0),
            "video_time": float(self.video_time),
        }

    def dispatch_stats(self) -> Dict[str, Any]:
        """``DispatchCounts`` since ``reset``."""
        return self._counts.as_dict()

    def swap_params(self, params):
        """Swap the model weights (a newly trained adapter, say) for the
        next step; the tree, its shapes and dtypes must be the old ones.
        As in the JAX engine, ingest already dispatched keeps the weights
        it ran with and what is resolved later runs on the new ones."""
        _check_same_tree(self.params, params)
        self.params = params
        self._set_encoder_connector()

    def maybe_backoff_spec(self, *, min_tokens_per_step: float = 1.15,
                           min_steps: int = 64):
        """Switch to plain greedy decoding when the measured acceptance
        makes drafting a net loss (at most ``min_tokens_per_step`` tokens
        per verify step over at least ``min_steps`` steps). Returns
        (backed_off, responses drained by flush)."""
        if not self.spec_decode:
            return False, []
        steps, emitted = (int(x) for x in self.spec_stats())
        if steps < min_steps or emitted >= min_tokens_per_step * steps:
            return False, []
        self.spec_decode = False
        return True, self.flush()

    def set_threshold(self, threshold: float):
        """Set the streaming gate's threshold for the next frames."""
        self.cfg = self.cfg.replace(
            frame_token_interval_threshold=float(threshold))

    def flush(self) -> List[Tuple[Optional[str], str]]:
        """Resolve every dispatch still in flight (and the queued frames
        and queries they unblock) and return the responses that produces;
        nothing on the blocking path, where every step resolves before it
        returns."""
        out = []
        call = self._call_spec if self.speculative else self._call_pipe
        while self._inflight or ((self.speculative or self.pipelined)
                                 and self.frame_embeds_queue):
            q, r = call(force_resolve=True)
            if r is not None:
                out.append((q, r))
            elif not self._inflight and not self.frame_embeds_queue:
                break
        return out

    def input_query_stream(self, query: str, video_time: Optional[float] = None):
        """Queue a user query; returns the user-facing NOTE string."""
        t = self.video_time if video_time is None else video_time
        self.query_queue.append((t, query))
        if not self._started:
            return (f'(NOTE: No video stream here. Please select or upload '
                    f'a video. Then the assistant will answer "{query} (at '
                    f'{self.video_time}s)" in the video stream)')
        return (f'(NOTE: Received "{query}" (at {self.video_time}s). Please '
                f'wait until previous frames have been processed)')

    def input_video_stream(self, video_time: float):
        """Project and enqueue all frames up to ``video_time``."""
        frame_idx = min(int(video_time * self.frame_fps),
                        self.num_video_frames - 1)
        if frame_idx > self.last_frame_idx:
            first = self.last_frame_idx + 1
            embeds = self._embed_chunk(
                self.video_tensor[first:frame_idx + 1])
            for off in range(frame_idx + 1 - first):
                self.frame_embeds_queue.append(
                    ((first + off) / self.frame_fps, embeds[off]))
            self.last_frame_idx = frame_idx
        self.video_time = video_time

    def _set_encoder_connector(self):
        """The connector the encoder applies: the model's own, or a copy on
        encoder_device."""
        self._enc_params = self.params
        if (self.vision_params is not None
                and self.encoder_device != self.device):
            self._enc_params = {"connector": _to_device(
                self.params["connector"], self.encoder_device)}

    def _embed_chunk(self, chunk: np.ndarray) -> torch.Tensor:
        """(T, ...) raw frames or features -> (T, fnt, hidden) on the
        device."""
        if chunk.dtype == np.uint8:
            if self.vision_params is None:
                raise ValueError("raw pixel input needs vision_params")
            pixels = to_device(torch.from_numpy(np.ascontiguousarray(chunk)),
                               self.encoder_device)
            # a copy between devices is ordered on the streams, not the host
            return to_device(live.pixels_to_embeds(
                self.vision_params, self._enc_params, pixels, self.cfg),
                self.device)
        feats = to_device(torch.from_numpy(np.ascontiguousarray(chunk)),
                          self.device)
        if feats.ndim == 2:  # (T, vision_hidden) = live1 layout
            feats = feats[:, None, :]
        flat = live.visual_embed(self.params, feats, self.cfg)
        return flat.reshape(-1, self.frame_num_tokens, self.hidden)

    # ------------------------------------------------------------ device steps
    def _forward(self, embeds, num_valid, **kw):
        return llama.forward(
            self.params["llama"], cfg=self.cfg.llama, inputs_embeds=embeds,
            kv_cache=self.cache, num_valid=torch.tensor([num_valid]),
            lora=self.params.get("lora"), lora_scaling=self._lora_scaling,
            attn_impl=self.attn_impl, **kw)

    def _embed_ids(self, ids) -> torch.Tensor:
        return llama.embed_tokens(self.params["llama"], ids, self.cfg.llama)

    def _gate(self, rows: torch.Tensor, threshold: float) -> torch.Tensor:
        """rows (K, V) logits -> next ids (K,): the interval token's
        probability is zeroed before the argmax when it is below the
        threshold (fp32 softmax, the gate bias added first)."""
        rows = rows.float()
        ref = self._gate_ref_id
        if self.cfg.gate_logit_bias:
            rows = rows.clone()
            rows[:, ref] += self.cfg.gate_logit_bias
        probs = torch.softmax(rows, dim=-1)
        below = probs[:, ref] < threshold
        masked = probs.clone()
        masked[:, ref] = torch.where(below, torch.zeros_like(probs[:, ref]),
                                     probs[:, ref])
        return torch.argmax(masked, dim=-1)

    def _prefill(self, ids, bucket: int):
        n = len(ids)
        embeds = self._embed_ids(_right_aligned(ids, bucket))
        # the prompt's logits are unused: skip the lm_head
        _, self.cache = self._forward(_pack_valid_first(embeds, bucket, n), n,
                                      return_hidden=True)

    def _ingest(self, first_ids, times, frames: List[torch.Tensor],
                threshold, *, chunk: bool, qae: bool = False, worst: int = 0
                ) -> "_Inflight":
        """Dispatch one ingest forward and start reading its gate ids back,
        without waiting for them. A single frame (``chunk`` false):
        [prepend] + its fnt tokens in a TEXT_BUCKET + fnt chunk, the gate
        read at its last token. A chunk (up to CHUNK_FRAMES frames): ONE
        forward laid out as the per-frame steps would feed them when no gate
        fires ([prepend] f0 , f1 , ...), zero frames padding the chunk, a
        gate at every frame's last token. The ring offset advances over
        every valid token; a fire rewinds it to the end of the fired
        frame."""
        base = self._ring_offset
        fnt = self.frame_num_tokens
        first_n = len(first_ids)
        t_emb = self._embed_ids(_right_aligned(first_ids, TEXT_BUCKET))
        if not chunk:
            embeds = torch.cat([t_emb, frames[0][None].to(t_emb.dtype)], dim=1)
            nv = first_n + fnt
            embeds = torch.roll(embeds, -(TEXT_BUCKET - first_n), dims=1)
            gather = torch.tensor([nv - 1])
        else:
            K, n = CHUNK_FRAMES, len(frames)
            iv = self.cfg.frame_token_interval_id
            itv = 1 if iv is not None else 0
            f_emb = torch.zeros((K, fnt, self.hidden), dtype=t_emb.dtype,
                                device=t_emb.device)
            f_emb[:n] = torch.stack(frames).to(t_emb.dtype)
            if itv:
                iv_emb = self._embed_ids(torch.tensor([[iv]]))[0]  # (1, D)
                unit = torch.cat([iv_emb[None].expand(K, 1, self.hidden),
                                  f_emb], dim=1)
                body = torch.cat([f_emb[0],
                                  unit[1:].reshape(-1, self.hidden)])
            else:
                body = f_emb.reshape(-1, self.hidden)
            embeds = torch.cat([t_emb[0], body])[None]
            embeds = torch.roll(embeds, -(TEXT_BUCKET - first_n), dims=1)
            nv = first_n + n * fnt + (n - 1) * itv
            gather = (first_n + fnt - 1 + torch.arange(K) * (fnt + itv))[None]
        logits, self.cache = self._forward(embeds, nv,
                                           logit_gather_positions=gather)
        self._counts.dispatched()
        return _Inflight(list(times), list(frames), first_n, base,
                         DeferredRead(self._gate(logits[0], threshold)), qae,
                         worst)

    def _tokens(self, first_n: int, consumed: int) -> int:
        """Ring slots the first ``consumed`` frames of an ingest take."""
        itv = 1 if self.cfg.frame_token_interval_id is not None else 0
        return (first_n + consumed * self.frame_num_tokens
                + max(consumed - 1, 0) * itv)

    def _settle(self, e: "_Inflight") -> Tuple[int, bool, int]:
        """Read an ingest's gate ids (waiting on its own readback alone):
        frames consumed up to and including the first fire, whether one
        fired, and the next id after the last consumed frame."""
        ids = self._counts.read(e.ids)
        n = len(e.frames)
        fired = (ids[:n] != self._gate_ref_id).nonzero()
        fire = len(fired) > 0
        consumed = int(fired[0]) + 1 if fire else n
        return consumed, fire, int(ids[consumed - 1])

    def _ingest_now(self, first_ids, frames, threshold, chunk: bool
                    ) -> Tuple[int, bool, int]:
        """The blocking step: dispatch, read the gates, and rewind the ring
        to the end of the consumed frames. Returns (consumed, fire,
        next_id)."""
        e = self._ingest(first_ids, [None] * len(frames), frames, threshold,
                         chunk=chunk)
        consumed, fire, next_id = self._settle(e)
        self.cache = llama.trim_kv_cache(
            self.cache, e.base + self._tokens(e.first_n, consumed))
        return consumed, fire, next_id

    def _generate(self, ids, bucket: int, hist_n: Optional[int] = None
                  ) -> np.ndarray:
        """One response (or, with stream_tokens, one segment) to the prompt
        ``ids`` (bucket-padded): greedy, or n-gram speculative with
        spec_decode (the same tokens). ``hist_n`` overrides how many prompt
        tokens enter the history ring: 0 for a continuation segment, whose
        1-token prompt is there already as the last emitted token."""
        n = len(ids)
        sel = _right_aligned(ids, bucket)
        embeds = _pack_valid_first(self._embed_ids(sel), bucket, n)
        if self.spec_decode:
            forced = None
            if self._forced_script is not None:
                script = self._forced_script
                forced = torch.from_numpy(
                    script[int(self._sstats[2]) % len(script)])
            out, length, self.cache, self._hist, self._hcount, st = (
                gen_mod.ngram_speculative_generate(
                    self.params, self.cfg, self.cache, embeds, [n],
                    self._hist, self._hcount,
                    prompt_ids=torch.roll(sel, -(bucket - n), dims=1)[0],
                    prompt_n=n if hist_n is None else hist_n,
                    max_new_tokens=self.max_new,
                    draft_len=self.spec_draft,
                    draft_mode=self.spec_draft_mode,
                    attn_impl=self.attn_impl, forced_ids=forced))
            self._sstats[:2] += st
            if forced is not None:
                self._sstats[2] += 1
        else:
            out, length, self.cache = gen_mod.greedy_generate(
                self.params, self.cfg, self.cache, embeds, [n],
                max_new_tokens=self.max_new, attn_impl=self.attn_impl)
        return out[0, :int(length[0])].numpy()

    # ------------------------------------------------------------- main loop
    def __call__(self) -> Tuple[Optional[str], Optional[str]]:
        """One streaming step: ingest queued frames until the model decides
        to respond or a query interleaves; then generate the response.
        Returns (query, response)."""
        if self.speculative:
            return self._call_spec()
        if self.pipelined:
            return self._call_pipe()
        return self._call_blocking()

    def _call_blocking(self) -> Tuple[Optional[str], Optional[str]]:
        if not self.frame_embeds_queue:
            return None, None
        video_time, query = self._stream_until_trigger()
        if video_time is None:
            return None, None
        return self._respond_at(video_time, query)

    # ------------------------------------------------ dispatch-ahead drivers
    def _assume_no_fire(self):
        """The prepend the next dispatch takes while the newest one's gate
        is unread: the interval token, which a gate that does not fire
        predicts by definition (none without an interval token)."""
        iv = self.cfg.frame_token_interval_id
        self._pending_prepend = [iv] if iv is not None else []

    def _rollback(self, e: _Inflight, consumed: int):
        """``e`` was resolved with ``consumed`` of its frames: every newer
        dispatch ingested a wrong continuation. Re-queue their frames and
        e's unconsumed ones, in order, and rewind the ring to the end of
        e's consumed frames (the stale slots past it are never attended and
        are overwritten)."""
        while self._inflight:
            n = self._inflight.pop()
            self._counts.rolled_back(len(n.frames))
            for item in reversed(list(zip(n.times, n.frames))):
                self.frame_embeds_queue.appendleft(item)
        for item in reversed(list(zip(e.times[consumed:],
                                      e.frames[consumed:]))):
            self.frame_embeds_queue.appendleft(item)
        self.cache = llama.trim_kv_cache(
            self.cache, e.base + self._tokens(e.first_n, consumed))

    def _resolve(self, e: _Inflight):
        """Read the oldest dispatch ``e``'s gates. A fire, or a query due
        at its last consumed frame, rolls back the newer dispatches and
        answers here (a query at the fired frame's time outranks the fire,
        as in the blocking engine); else the newer dispatches assumed the
        right continuation. Returns (query, response) or None."""
        consumed, fire, next_id = self._settle(e)
        t = e.times[consumed - 1]
        self.video_time_processed = t
        due = bool(self.query_queue) and t >= self.query_queue[0][0]
        if not (fire or due):
            return None
        self._rollback(e, consumed)
        self._pending_prepend = []
        if due:
            qt, q = self.query_queue.popleft()
            return self._respond_at(qt, q)
        return self._respond_at(t, None)

    def _spec_fill(self, may_compact: bool = True):
        """Dispatch queued frames one at a time up to two in flight, never
        past a query boundary, each assuming the previous gate holds.
        Without ``may_compact`` a full ring stops the fill instead."""
        thr = float(self.cfg.frame_token_interval_threshold)
        while len(self._inflight) < 2 and self.frame_embeds_queue:
            t, emb = self.frame_embeds_queue[0]
            if self.query_queue and t > self.query_queue[0][0]:
                break  # the query is answered before this frame
            # the ring as dispatched, plus this frame and a gate-fire turn
            worst = (self._ring_offset + TEXT_BUCKET + self.frame_num_tokens
                     + self._gen_prompt_bucket + self.cfg.max_response_tokens)
            if worst > self.kv_capacity:
                if self._inflight or not may_compact:
                    break  # resolve in-flight work first, then compact
                worst = self._maybe_compact(worst)
                if worst > self.kv_capacity:
                    raise RuntimeError(
                        f"KV ring capacity {self.kv_capacity} would be "
                        f"exceeded (offset {self._host_offset}); raise "
                        f"kv_capacity, set stream_window, or reset()")
            e = self._ingest(self._take_prepend(), [t], [emb], thr,
                             chunk=False)
            self.frame_embeds_queue.popleft()
            self._inflight.append(e)
            self._counts.inflight(len(self._inflight))
            self._assume_no_fire()

    def _call_spec(self, force_resolve: bool = False
                   ) -> Tuple[Optional[str], Optional[str]]:
        # a backlog with nothing in flight takes the chunked blocking step
        if not self._inflight and len(self.frame_embeds_queue) > 1:
            return self._call_blocking()
        idle = not self.frame_embeds_queue
        self._spec_fill()
        # the newest dispatch stays unresolved, its readback overlapping
        # the next frame's dispatch, unless a newer one is in flight, a
        # query may be due, the call brought no frame, or the caller
        # drains (flush)
        if self._inflight and (force_resolve or len(self._inflight) >= 2
                                 or self.query_queue or idle):
            out = self._resolve(self._inflight.popleft())
            if out is None:
                return None, None
            # the next frame goes out behind the response
            self._spec_fill(may_compact=False)
            return out
        # idle pipeline: a query strictly before the next frame answers now
        if (self.query_queue and self.frame_embeds_queue
                and self.frame_embeds_queue[0][0] > self.query_queue[0][0]):
            t, q = self.query_queue.popleft()
            self._pending_prepend = []
            return self._respond_at(t, q)
        return None, None

    def _collect_burst(self) -> Optional[Dict[str, Any]]:
        """The next pipelined dispatch from the queue head, laid out as the
        blocking step lays it out: the burst is the frames up to the next
        query's time, or what is left of the burst being dispatched, and
        it goes out CHUNK_FRAMES frames at a time, as chunks when it held
        two frames or more. Returns that group, its layout, the burst's
        frames left after it, whether the query falls due at its end, and
        the ring slots it reserves: its ingest plus one response turn.
        None when no frame precedes the next query."""
        qt = self.query_queue[0][0] if self.query_queue else None
        cont = self._burst_left
        burst = []
        for t, e in self.frame_embeds_queue:
            if (qt is not None and t > qt) or (cont and len(burst) >= cont):
                break
            burst.append((t, e))
        if not burst:
            return None
        group = burst[:CHUNK_FRAMES]
        qae = qt is not None and group[-1][0] >= qt
        n = len(self._gen_prompt_ids)
        if qae:
            n = max(n, len(self.tokenizer.apply_chat_template(
                [{"role": "user", "content": self.query_queue[0][1]}],
                tokenize=True, add_stream_query_prompt=True,
                add_generation_prompt=True)))
        bucket = next((b for b in PROMPT_BUCKETS if b >= n), n)
        return {"group": group, "chunk": bool(cont) or len(burst) >= 2,
                "left": len(burst) - len(group), "qae": qae,
                "worst": (len(group) * (TEXT_BUCKET + self.frame_num_tokens)
                          + bucket + self.cfg.max_response_tokens)}

    def _pipe_fill(self) -> int:
        """Dispatch bursts up to the pipeline depth, each assuming the
        previous one's gates hold, and none past a query turn. Sets
        ``_pipe_blocked`` when the capacity guard, which reserves every
        in-flight burst's worst case, stops a dispatch. Returns the bursts
        dispatched."""
        self._pipe_blocked = False
        added = 0
        thr = float(self.cfg.frame_token_interval_threshold)
        while (len(self._inflight) < self.pipeline_depth
               and self.frame_embeds_queue):
            if self._inflight and self._inflight[-1].qae:
                break  # a query turn follows the newest dispatch
            if (self.query_queue and self.frame_embeds_queue[0][0]
                    > self.query_queue[0][0]):
                break  # a query turn comes first
            b = self._collect_burst()
            if b is None:
                break
            if (self._host_offset + sum(e.worst for e in self._inflight)
                    + b["worst"] > self.kv_capacity):
                self._pipe_blocked = True
                break
            times = [t for t, _ in b["group"]]
            e = self._ingest(self._take_prepend(), times,
                             [f for _, f in b["group"]], thr,
                             chunk=b["chunk"], qae=b["qae"], worst=b["worst"])
            for _ in times:
                self.frame_embeds_queue.popleft()
            self._burst_left = b["left"]
            self._inflight.append(e)
            added += 1
            self._counts.inflight(len(self._inflight))
            self._assume_no_fire()
        return added

    def _call_pipe(self, force_resolve: bool = False
                   ) -> Tuple[Optional[str], Optional[str]]:
        """Ingest the queued bursts, keeping up to ``pipeline_depth``
        dispatches in flight, until a response turn or until the newest
        dispatch is the only one left (its readback overlaps whatever the
        caller does next). A call that finds nothing to dispatch resolves
        what is in flight."""
        idle = None
        while True:
            added = self._pipe_fill()
            if idle is None:
                idle = not added and not self.frame_embeds_queue
            blocked_query = bool(self.query_queue and self.frame_embeds_queue
                                 and self.frame_embeds_queue[0][0]
                                 > self.query_queue[0][0])
            if blocked_query and not self._inflight:
                t, q = self.query_queue.popleft()
                self._pending_prepend = []
                return self._respond_at(t, q)
            # resolve the oldest when the pipe is full, a query or the ring
            # needs it, the call is idle or the caller drains; a response
            # turn drains the pipe (responses run with nothing in flight)
            if not (self._inflight and (force_resolve or idle
                                    or len(self._inflight) >= self.pipeline_depth
                                    or blocked_query or self._pipe_blocked
                                    or self._inflight[-1].qae)):
                break
            out = self._resolve(self._inflight.popleft())
            if out is not None:
                self._pipe_fill()  # the next burst goes out behind it
                return out
        if self._pipe_blocked and not self._inflight:
            # the ring is too tight even with nothing in flight: one
            # blocking step (its guard compacts or raises) keeps progress
            return self._call_blocking()
        return None, None

    def _finish_response(self, out: np.ndarray, video_time, query
                         ) -> Tuple[Optional[str], str]:
        """The final token (EOS or budget-limited last) is NOT in the cache:
        it is fed with the next frame append, after the stream reopen ids
        when it is EOS."""
        out = np.asarray(out, np.int32)
        if out.size and out[-1] == self.cfg.eos_token_id:
            self._pending_prepend = [int(out[-1])] + list(
                self._stream_prompt_ids)
        elif out.size:
            self._pending_prepend = [int(out[-1])]
        response = self.tokenizer.decode(out, skip_special_tokens=True)
        q_str = (f"(Video Time = {video_time}s) User: {query}"
                 if query else None)
        return q_str, f"(Video Time = {video_time}s) Assistant:{response}"

    def _finish_or_continue(self, out: np.ndarray, video_time, query):
        """With stream_tokens = S the first segment stopped after at most S
        tokens: surface its text through on_delta and decode S-token
        continuation segments (each prompted by the last sampled token, as
        the unsegmented decode feeds it) until EOS or the response budget.
        The joined segments are the unsegmented response, so the
        transcript is the same."""
        S = self.stream_tokens
        if not S:
            return self._finish_response(out, video_time, query)
        out = np.asarray(out, np.int32)
        budget = self.cfg.max_response_tokens
        parts = [out]
        total = int(out.size)
        surfaced = ""

        def emit(done: bool):
            # once per segment, even when its text is empty (the first call
            # is the time to first text)
            nonlocal surfaced
            text = self.tokenizer.decode(np.concatenate(parts),
                                         skip_special_tokens=True)
            delta, surfaced = text[len(surfaced):], text
            if self.on_delta is not None:
                self.on_delta(delta, done)

        while (total < budget and out.size == S
               and int(out[-1]) != self.cfg.eos_token_id):
            emit(False)
            out = self._respond_continue(int(out[-1]))
            parts.append(out)
            total += int(out.size)
        emit(True)
        return self._finish_response(np.concatenate(parts), video_time, query)

    def _respond_continue(self, last_tok: int) -> np.ndarray:
        """One S-token continuation segment. The first segment's capacity
        guard reserved the whole response budget, so none runs here."""
        return self._generate([last_tok], PROMPT_BUCKETS[0], hist_n=0)

    def _maybe_compact(self, worst: int) -> int:
        """If the next write would overflow and a stream_window is set,
        evict everything older than the window (the newest window moves to
        the ring's front; pos_base keeps absolute positions). Returns the
        worst-case occupancy after it."""
        if (worst <= self.kv_capacity or self.stream_window is None
                or self._host_offset <= self.stream_window):
            return worst
        # compaction moves slots relative to the offset: nothing in flight
        assert not self._inflight, "compaction in flight"
        freed = self._host_offset - self.stream_window
        self.cache = llama.compact_kv_cache(self.cache, self.stream_window)
        return worst - freed

    def _stream_until_trigger(self):
        while self.frame_embeds_queue:
            # a query strictly earlier than the next frame -> answer now
            if (self.query_queue
                    and self.frame_embeds_queue[0][0] > self.query_queue[0][0]):
                return self.query_queue.popleft()
            # burst = frames up to (and incl.) the next query time, or the
            # rest of the pipelined driver's burst
            qt = self.query_queue[0][0] if self.query_queue else None
            cont, self._burst_left = self._burst_left, 0
            burst_times, burst_embeds = [], []
            for t, e in self.frame_embeds_queue:
                if ((qt is not None and t > qt)
                        or (cont and len(burst_times) >= cont)):
                    break
                burst_times.append(t)
                burst_embeds.append(e)
            if not burst_times:
                return self.query_queue.popleft()

            # capacity guard: the burst plus the gate-fire response turn that
            # may follow; query turns are guarded in _respond_at
            worst = (self._host_offset + len(burst_times)
                     * (TEXT_BUCKET + self.frame_num_tokens)
                     + self._gen_prompt_bucket + self.cfg.max_response_tokens)
            worst = self._maybe_compact(worst)
            if worst > self.kv_capacity:
                raise RuntimeError(
                    f"KV ring capacity {self.kv_capacity} would be exceeded "
                    f"(offset {self._host_offset}); raise kv_capacity, set "
                    f"stream_window, or reset() the stream")
            first_ids = self._take_prepend()
            thr = float(self.cfg.frame_token_interval_threshold)
            if len(burst_times) >= 2 or cont:
                consumed, fire, next_id = self._ingest_chunks(
                    burst_embeds, first_ids, thr)
            else:
                consumed, fire, next_id = self._ingest_now(
                    first_ids, burst_embeds, thr, chunk=False)
            for _ in range(consumed):
                self.frame_embeds_queue.popleft()
            if consumed:
                self.video_time_processed = burst_times[consumed - 1]
            if fire:
                # a query at the fired frame's time takes priority
                if (self.query_queue and consumed
                        and burst_times[consumed - 1] >= self.query_queue[0][0]):
                    self._pending_prepend = []
                    return self.query_queue.popleft()
                # the gate fired: the predicted token is dropped and
                # ']\nAssistant:' is fed instead
                self._pending_prepend = []
                return burst_times[consumed - 1], None
            if consumed:
                self._pending_prepend = (
                    [next_id] if self.cfg.frame_token_interval_id is not None
                    else [])
            if (self.query_queue and consumed
                    and burst_times[consumed - 1] >= self.query_queue[0][0]):
                return self.query_queue.popleft()
        return None, None

    def _ingest_chunks(self, burst_embeds, first_ids, thr):
        """CHUNK_FRAMES frames per forward, stopping at the first fire."""
        total, fire, next_id, i = 0, False, 0, 0
        iv = self.cfg.frame_token_interval_id
        cont_ids = [iv] if iv is not None else []
        while i < len(burst_embeds) and not fire:
            group = burst_embeds[i:i + CHUNK_FRAMES]
            consumed, fire, next_id = self._ingest_now(
                first_ids if i == 0 else cont_ids, group, thr, chunk=True)
            total += consumed
            i += consumed
        return total, fire, next_id

    def _take_prepend(self) -> List[int]:
        """Pending text ids for the next frame step (at most TEXT_BUCKET).
        The first step prefills the system prompt on its own."""
        if not self._started:
            self._prefill_ids(self._start_ids)
            self._started = True
            self._pending_prepend = []
        ids = self._pending_prepend[-TEXT_BUCKET:]
        self._pending_prepend = []
        return ids

    def _prefill_ids(self, ids: np.ndarray):
        n = len(ids)
        bucket = next((b for b in PROMPT_BUCKETS if b >= n), n)
        self._prefill([int(i) for i in ids], bucket)

    def _respond_at(self, video_time, query):
        self._burst_left = 0  # a response turn ends the burst
        if query is not None:
            # the pending predicted token is REPLACED by the query prompt
            self._pending_prepend = []
            prompt = self.tokenizer.apply_chat_template(
                [{"role": "user", "content": query}], tokenize=True,
                add_stream_query_prompt=True, add_generation_prompt=True)
        else:
            prompt = self._gen_prompt_ids
        self._started = True
        n = len(prompt)
        bucket = next((b for b in PROMPT_BUCKETS if b >= n), n)
        # capacity guard for the response turn itself
        worst = self._host_offset + bucket + self.cfg.max_response_tokens
        worst = self._maybe_compact(worst)
        if worst > self.kv_capacity:
            raise RuntimeError(
                f"KV ring capacity {self.kv_capacity} would be exceeded by "
                f"the response turn (offset {self._host_offset}, prompt "
                f"bucket {bucket}); raise kv_capacity, set stream_window, "
                f"or reset()")
        out = self._generate(list(prompt), bucket)
        return self._finish_or_continue(out, video_time, query)
