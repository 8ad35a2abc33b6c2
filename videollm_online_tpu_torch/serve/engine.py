"""LiveInferEngine — the single-stream streaming serving loop, in PyTorch.

Counterpart of the blocking path of
``videollm_online_tpu/serve/engine.py`` (``fused_respond=False``): the same
public API (``load_video`` / ``input_video_stream`` / ``input_query_stream``
/ ``__call__`` / ``reset``) and the same transcripts. Frames are ingested
one forward per frame, or ``CHUNK_FRAMES`` frames in one forward when a
burst holds several; the response gate (P(interval) against the threshold)
is read at every frame's last token; a fire rewinds the ring offset to the
end of the fired frame. Responses are greedy, or n-gram speculative when
``spec_decode`` is on (the same transcripts).

The JAX engine's other drivers (fused, multi-response, pipelined and
speculative dispatch, the device-constant cache) exist to hide round trips
through a remote TPU link and are not ported. The KV ring is updated in
place.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import LiveConfig
from ..core.device import resolve_device
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


def _load_features(path: str) -> np.ndarray:
    """A feature file as the JAX package's ``data/video_io.load_array``
    reads it."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return z[list(z.keys())[0]]
    if path.endswith(".pt"):
        t = torch.load(path, weights_only=True, map_location="cpu")
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    raise NotImplementedError(
        f"{path}: video files need the vision slice; the port reads "
        f"pre-extracted features (.npy, .npz, .pt)")


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
        fused_respond: bool = False,
        multi_respond: bool = False,
        pipelined: bool = False,
        speculative: bool = False,
        spec_forced_script=None,
        on_delta=None,
    ):
        deferred = {"vision_params": vision_params is not None,
                    "encoder_device": encoder_device is not None,
                    "stream_window": stream_window is not None,
                    "kv_quant": kv_quant is not None,
                    "stream_tokens": stream_tokens is not None,
                    "fused_respond": fused_respond,
                    "multi_respond": multi_respond,
                    "pipelined": pipelined,
                    "speculative": speculative,
                    "spec_forced_script": spec_forced_script is not None,
                    "on_delta": on_delta is not None}
        asked = [k for k, on in deferred.items() if on]
        if asked:
            raise NotImplementedError(
                f"not ported yet: {', '.join(asked)} (the port serves the "
                f"blocking path over pre-extracted features)")
        if spec_draft_mode not in ("ngram", "zero"):
            raise ValueError(f"spec_draft_mode {spec_draft_mode!r}")
        self.device = resolve_device(device)
        self.params = params
        self.tokenizer = tokenizer
        self.cfg = cfg or tokenizer.cfg
        if self.cfg.v_placeholder_id is None:
            raise ValueError("config is missing its tokenizer ids")
        self.spec_decode = spec_decode
        # K = budget - 1 lets one verify step finish a predicted response;
        # capped at 19 for long budgets
        self.spec_draft = int(spec_draft or max(
            1, min(self.cfg.max_response_tokens - 1, 19)))
        self.spec_draft_mode = spec_draft_mode
        self.max_new = self.cfg.max_response_tokens
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
            device=self.device)
        self._started = False
        # pending text prepend (token ids) to feed before the next frame
        self._pending_prepend: List[int] = []
        # spec_decode: token-history ring, its count, [verify_steps, emitted]
        self._hist = torch.zeros((gen_mod.SPEC_HIST,), dtype=torch.int32)
        self._hcount = torch.tensor(0, dtype=torch.int32)
        self._sstats = torch.zeros((2,), dtype=torch.int32)

    @property
    def _host_offset(self) -> int:
        return int(self.cache.offset[0])

    # ------------------------------------------------------------------ I/O
    def load_video(self, video: Any):
        """Pre-extracted features (T, vision_hidden) or (T, fnt,
        vision_hidden), as an array or a path to one (``.npy``, ``.npz``,
        ``.pt``). Video containers and raw frames are a later slice."""
        if isinstance(video, str):
            video = _load_features(video)
        video = np.asarray(video)
        if video.dtype == np.uint8:
            raise NotImplementedError("raw pixels need the vision slice")
        self.video_tensor = video
        self.num_video_frames = video.shape[0]
        self.video_duration = video.shape[0] / self.frame_fps

    def spec_stats(self) -> np.ndarray:
        """[verify_steps, emitted_tokens] accumulated by spec_decode
        responses; mean accepted drafts per step = tokens / steps - 1."""
        return self._sstats.numpy().copy()

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

    def _embed_chunk(self, chunk: np.ndarray) -> torch.Tensor:
        """(T, ...) features -> (T, fnt, hidden) on the device."""
        feats = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
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

    def _burst(self, first_ids, frames: List[torch.Tensor], threshold
               ) -> Tuple[int, bool, int]:
        """One forward per frame ([prepend] + fnt frame tokens in a
        TEXT_BUCKET + fnt chunk), stopping at the first gate fire. Returns
        (consumed, fire, next_id)."""
        use_interval = self.cfg.frame_token_interval_id is not None
        interval_ids = [self._gate_ref_id] if use_interval else []
        fire, next_id, i = False, 0, 0
        while i < len(frames) and not fire:
            ids = first_ids if i == 0 else interval_ids
            t_emb = self._embed_ids(_right_aligned(ids, TEXT_BUCKET))
            embeds = torch.cat([t_emb, frames[i][None].to(t_emb.dtype)], dim=1)
            nv = len(ids) + self.frame_num_tokens
            embeds = torch.roll(embeds, -(TEXT_BUCKET - len(ids)), dims=1)
            logits, self.cache = self._forward(
                embeds, nv, logit_gather_positions=torch.tensor([nv - 1]))
            next_id = int(self._gate(logits[0], threshold)[0])
            fire = next_id != self._gate_ref_id
            i += 1
        return i, fire, next_id

    def _chunk(self, first_ids, frames: List[torch.Tensor], threshold
               ) -> Tuple[int, bool, int]:
        """Up to CHUNK_FRAMES frames in ONE forward, laid out as the
        per-frame loop would feed them when no gate fires
        ([prepend] f0 , f1 , ...), zero frames padding the chunk. Gates are
        read at every frame's last token; on a fire at frame i the ring
        offset is rewound to the end of frame i (the tokens past it are
        never attended and are overwritten). Returns (consumed, fire,
        next_id)."""
        K, n = CHUNK_FRAMES, len(frames)
        fnt = self.frame_num_tokens
        iv = self.cfg.frame_token_interval_id
        itv = 1 if iv is not None else 0
        per = fnt + itv
        first_n = len(first_ids)
        t_emb = self._embed_ids(_right_aligned(first_ids, TEXT_BUCKET))[0]
        f_emb = torch.zeros((K, fnt, self.hidden), dtype=t_emb.dtype,
                            device=t_emb.device)
        f_emb[:n] = torch.stack(frames).to(t_emb.dtype)
        if itv:
            iv_emb = self._embed_ids(torch.tensor([[iv]]))[0]     # (1, D)
            unit = torch.cat([iv_emb[None].expand(K, 1, self.hidden), f_emb],
                             dim=1)
            body = torch.cat([f_emb[0], unit[1:].reshape(-1, self.hidden)])
        else:
            body = f_emb.reshape(-1, self.hidden)
        embeds = torch.cat([t_emb, body])[None]
        embeds = torch.roll(embeds, -(TEXT_BUCKET - first_n), dims=1)
        valid = first_n + n * fnt + max(n - 1, 0) * itv
        ends = first_n + fnt - 1 + torch.arange(K) * per
        base = self._host_offset
        logits, self.cache = self._forward(embeds, valid,
                                           logit_gather_positions=ends[None])
        next_ids = self._gate(logits[0], threshold).cpu()
        fires = (next_ids != self._gate_ref_id) & (torch.arange(K) < n)
        fired = fires.nonzero()
        fire = len(fired) > 0
        consumed = int(fired[0]) + 1 if fire else n
        consumed_tokens = first_n + consumed * fnt + max(consumed - 1, 0) * itv
        self.cache = llama.trim_kv_cache(self.cache, base + consumed_tokens)
        return consumed, fire, int(next_ids[consumed - 1])

    def _generate(self, ids, bucket: int) -> np.ndarray:
        """One response to the prompt ``ids`` (bucket-padded): greedy, or
        n-gram speculative with spec_decode (the same tokens)."""
        n = len(ids)
        sel = _right_aligned(ids, bucket)
        embeds = _pack_valid_first(self._embed_ids(sel), bucket, n)
        if self.spec_decode:
            out, length, self.cache, self._hist, self._hcount, st = (
                gen_mod.ngram_speculative_generate(
                    self.params, self.cfg, self.cache, embeds, [n],
                    self._hist, self._hcount,
                    prompt_ids=torch.roll(sel, -(bucket - n), dims=1)[0],
                    prompt_n=n, max_new_tokens=self.max_new,
                    draft_len=self.spec_draft,
                    draft_mode=self.spec_draft_mode,
                    attn_impl=self.attn_impl))
            self._sstats += st
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
        if not self.frame_embeds_queue:
            return None, None
        video_time, query = self._stream_until_trigger()
        if video_time is None:
            return None, None
        return self._respond_at(video_time, query)

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

    def _stream_until_trigger(self):
        while self.frame_embeds_queue:
            # a query strictly earlier than the next frame -> answer now
            if (self.query_queue
                    and self.frame_embeds_queue[0][0] > self.query_queue[0][0]):
                return self.query_queue.popleft()
            # burst = frames up to (and incl.) the next query time
            qt = self.query_queue[0][0] if self.query_queue else None
            burst_times, burst_embeds = [], []
            for t, e in self.frame_embeds_queue:
                if qt is not None and t > qt:
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
            if worst > self.kv_capacity:
                raise RuntimeError(
                    f"KV ring capacity {self.kv_capacity} would be exceeded "
                    f"(offset {self._host_offset}); raise kv_capacity or "
                    f"reset() the stream")
            first_ids = self._take_prepend()
            thr = float(self.cfg.frame_token_interval_threshold)
            if len(burst_times) >= 2:
                consumed, fire, next_id = self._ingest_chunks(
                    burst_embeds, first_ids, thr)
            else:
                consumed, fire, next_id = self._burst(
                    first_ids, burst_embeds, thr)
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
            consumed, fire, next_id = self._chunk(
                first_ids if i == 0 else cont_ids, group, thr)
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
        if worst > self.kv_capacity:
            raise RuntimeError(
                f"KV ring capacity {self.kv_capacity} would be exceeded by "
                f"the response turn (offset {self._host_offset}, prompt "
                f"bucket {bucket}); raise kv_capacity or reset()")
        out = self._generate(list(prompt), bucket)
        return self._finish_response(out, video_time, query)
