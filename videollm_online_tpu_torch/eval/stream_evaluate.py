"""Streaming evaluation: LM-PPL, frame_diff, fluency, LM-correctness.

Counterpart of ``videollm_online_tpu/eval/stream_evaluate.py`` (reference
``LiveMixin.stream_evaluate``, models/modeling_live.py:44-168): ONE
full-sequence forward into a fresh KV ring gives four per-token vectors
(NLL at the label, argmax id, argmax excluding the interval id,
P(interval)) through a chunked lm_head; the turn scan runs on the host over
those small vectors. The rollforward branch (the model never fired inside a
turn, modeling_live.py:116-148) appends future frames with placeholder ids
after rewinding the ring to the turn boundary.

The whole-video prefill attends through ``_prefill_attn``: on the card, the
flash kernel K2f over the ring's first T slots (the sequence is padded to a
128 multiple for it); elsewhere the plain attention, as the JAX package
sends it to XLA off the TPU. The JAX package copies the whole ring for each
rollforward so later turns see the original rows; the port saves the rows
the append overwrites and puts them back, which is the same function
without the copy of the ring.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.config import LiveConfig
from ..models import live, llama
from ..ops.flash_attention import flash_attention
from ..train.optim import tree_leaves

IGNORE = -100

# lm_head chunk length: the stats reduce each position to 4 scalars, so the
# (T, V) logits never exist at once; a chunk holds LM_CHUNK x V fp32 logits
# (1 GB at 2048 x 128256)
LM_CHUNK = 2048

FLASH_HEAD_DIMS = (64, 128, 256)


def _flash_route(q, k_scale) -> bool:
    """Whether the prefill of q (B, Hq, T, d) takes the flash kernel: on
    the card, over a ring in the model dtype, for T a multiple of 128 and
    d in FLASH_HEAD_DIMS (JAX ``stream_evaluate.py:50-51``)."""
    return (q.is_cuda and k_scale is None and q.shape[2] % 128 == 0
            and q.shape[3] in FLASH_HEAD_DIMS)


def _prefill_attn(q, k, v, q_pos, kv_valid_upto, *, num_groups,
                  sliding_window=None, k_scale=None, v_scale=None):
    """Whole-video fresh-ring prefill attention for the eval forward.

    ``_per_token_stats`` runs ONE forward into a ring at offset 0, so the
    ring's first T slots ARE the chunk's own K/V, and slot i is position i.
    The plain attention would build (Hq, T, capacity) fp32 scores, 50 GB at
    a 10-minute 8B video; on the card the flash kernel (K2f) reads the ring
    sliced to the query length instead (T is padded to a 128 multiple by
    ``StreamEvaluator.__call__``). It has no ``layered`` form, so the
    decoder passes it the ring's layer (models/llama.py ``_layer``)."""
    T = q.shape[2]
    if _flash_route(q, k_scale):
        return flash_attention(q, k[:, :, :T], v[:, :, :T],
                               1.0 / q.shape[3] ** 0.5, True, 0,
                               window=sliding_window)
    return llama._attention(q, k, v, q_pos, kv_valid_upto,
                            num_groups=num_groups,
                            sliding_window=sliding_window, k_scale=k_scale,
                            v_scale=v_scale)


def _lora(params, cfg: LiveConfig):
    lora = params.get("lora")
    scaling = (cfg.lora.scaling
               if (cfg.lora is not None and lora is not None) else 1.0)
    return lora, scaling


def _chunk_stats(params, cfg: LiveConfig, h, interval_id: int, labels=None):
    """(nll or None, argmax, argmax excluding the interval id, P(interval))
    for the hidden rows h (T, D), through lm_head LM_CHUNK rows at a time;
    each chunk's fp32 logits reduce to those four per row."""
    lora, scaling = _lora(params, cfg)
    outs = []
    for i in range(0, h.shape[0], LM_CHUNK):
        lg = llama.lm_head(params["llama"], h[i:i + LM_CHUNK], cfg.llama,
                           lora=lora, lora_scaling=scaling).float()
        lse = torch.logsumexp(lg, dim=-1)
        nll = (None if labels is None else
               lse - lg.gather(1, labels[i:i + LM_CHUNK, None])[:, 0])
        argmax = lg.argmax(dim=-1)
        p_int = torch.exp(lg[:, interval_id] - lse)
        lg[:, interval_id] = -torch.inf    # lg is this chunk's own copy
        outs.append((nll, argmax, lg.argmax(dim=-1), p_int))
    cat = [None if parts[0] is None else torch.cat(parts).cpu().numpy()
           for parts in zip(*outs)]
    return tuple(cat)


def _per_token_stats(params, cfg: LiveConfig, input_ids, labels, frames,
                     interval_id: int, kv_cache, attn_impl=_prefill_attn):
    """The full decoder forward (hidden states only) into ``kv_cache`` (in
    place), then the chunked lm_head: host arrays nll, argmax, argmax_excl,
    p_interval, each (T,)."""
    embeds = live.joint_embed(params, cfg, input_ids, frames)
    lora, scaling = _lora(params, cfg)
    hidden, _ = llama.forward(
        params["llama"], cfg=cfg.llama, inputs_embeds=embeds,
        kv_cache=kv_cache, lora=lora, lora_scaling=scaling,
        return_hidden=True, attn_impl=attn_impl)
    lab = labels[0].clamp(0, cfg.llama.vocab_size - 1)
    return _chunk_stats(params, cfg, hidden[0], interval_id, lab)


def _rollforward_stats(params, cfg: LiveConfig, cache, append_ids,
                       append_frames, interval_id: int):
    """The rollforward forward (modeling_live.py:128-141) over the ring
    (written in place), with the same chunked lm_head: host arrays argmax,
    argmax_excl, p_interval."""
    embeds = live.joint_embed(params, cfg, append_ids, append_frames)
    lora, scaling = _lora(params, cfg)
    hidden, _ = llama.forward(
        params["llama"], cfg=cfg.llama, inputs_embeds=embeds,
        kv_cache=cache, lora=lora, lora_scaling=scaling, return_hidden=True)
    return _chunk_stats(params, cfg, hidden[0], interval_id)[1:]


class StreamEvaluator:
    """``attn_impl`` is the prefill's attention: ``_prefill_attn`` unless
    the caller gives another (the plain ``llama._attention``, to hold the
    kernel route against it)."""

    def __init__(self, params, cfg: LiveConfig, attn_impl=None):
        self.params = params
        self.cfg = cfg
        use_interval = cfg.frame_token_interval_id is not None
        self.interval_id = (cfg.frame_token_interval_id if use_interval
                            else cfg.eos_token_id)
        self.use_interval = use_interval
        self.attn_impl = attn_impl or _prefill_attn
        self.device = tree_leaves(params["llama"])[0].device

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _frames(self, frames):
        if frames is None or not np.size(frames):
            return None
        return self._tensor(frames, torch.float32)

    def _gate_fire_index(self, argmax, argmax_excl, p_int, threshold):
        """First index whose gate prediction is not the interval token.
        Reference zeroes P(interval) below the threshold then argmaxes
        (modeling_live.py:107-113)."""
        if threshold > 0:
            pred = np.where(p_int < threshold, argmax_excl, argmax)
        else:
            pred = argmax
        fire = pred != self.interval_id
        idx = np.nonzero(fire)[0]
        return int(idx[0]) if idx.size else None

    @torch.no_grad()
    def __call__(self, input_ids: np.ndarray, labels: np.ndarray,
                 frames: Optional[np.ndarray],
                 frame_token_interval_threshold: float = 0.0) -> np.ndarray:
        """input_ids/labels: (1, T); frames: flattened frame features.
        Returns [lm_ppl, frame_diff, fluency, lm_correctness]."""
        cfg = self.cfg
        input_ids = np.asarray(input_ids)
        labels = np.asarray(labels)
        assert input_ids.shape[0] == 1
        input_id = input_ids[0]
        label = labels[0]
        T = len(input_id)
        fnt = cfg.frame_num_tokens

        # turn boundaries: eos positions (modeling_live.py:60-62)
        stops = (np.nonzero(input_id == cfg.eos_token_id)[0] + 1).tolist()
        starts = [0] + stops[:-1]
        num_turns = len(starts)

        v_mask_all = input_id == cfg.v_placeholder_id

        # capacity with rollforward headroom: the rollforward appends at most
        # min(next turn's frames, this turn's frames - 1) frame units beyond
        # T, bounded exactly from the sample
        per_frame_append = fnt + (1 if self.use_interval else 0)
        turn_frames = [int(v_mask_all[ts:te].sum()) // fnt
                       for ts, te in zip(starts, stops)]
        max_roll = max(
            (min(turn_frames[r + 1], turn_frames[r] - 1)
             for r in range(num_turns - 1)), default=0)
        capacity = T + max(max_roll, 0) * per_frame_append
        # pad the prefill to a 128 multiple so _prefill_attn can take the
        # flash kernel (pad ids are eos, never <v>, labels IGNORE; causal
        # attention leaves positions < T untouched, and the turn scan only
        # indexes real positions)
        T_pad = -(-T // 128) * 128
        if T_pad != T:
            input_ids = np.pad(input_ids, ((0, 0), (0, T_pad - T)),
                               constant_values=cfg.eos_token_id)
            labels = np.pad(labels, ((0, 0), (0, T_pad - T)),
                            constant_values=IGNORE)
        capacity = max(capacity, T_pad)
        cache = llama.init_kv_cache(cfg.llama, batch=1, capacity=capacity,
                                    device=self.device)
        nll, argmax, argmax_excl, p_int = _per_token_stats(
            self.params, cfg, self._tensor(input_ids, torch.long),
            self._tensor(labels, torch.long), self._frames(frames),
            self.interval_id, cache, self.attn_impl)
        learn_mask_all = label != IGNORE

        lm_ppls, frame_diffs, fluencies, lm_corrects = [], [], [], []
        past_num_frames = 0
        for r, (ts, te) in enumerate(zip(starts, stops)):
            turn_learn = learn_mask_all[ts:te]
            if not turn_learn.any():
                continue
            turn_v = v_mask_all[ts:te]
            turn_num_frames = int(turn_v.sum()) // fnt
            turn_stream = turn_v & turn_learn
            turn_lm = turn_learn & ~turn_stream

            num_lm_correct = 0
            lm_count = 0
            if turn_lm.any():
                idxs = np.nonzero(turn_lm)[0] + ts
                lm_ppls.append(float(np.exp(nll[idxs].mean())))
                wrong = argmax[idxs] != label[idxs]
                if wrong.any():
                    num_lm_correct = int(np.nonzero(wrong)[0][0])
                else:
                    num_lm_correct = int(len(idxs))
                lm_count = len(idxs)
                lm_corrects.append(num_lm_correct / lm_count)

            frame_diff = None
            if turn_stream.any():
                sidx = np.nonzero(turn_stream)[0] + ts
                fire = self._gate_fire_index(
                    argmax[sidx], argmax_excl[sidx], p_int[sidx],
                    frame_token_interval_threshold)
                if fire is not None:
                    frame_diff = int(turn_stream.sum()) - fire - 1
                else:
                    # rollforward: assume the 'Assistant: ...' never happened
                    # and keep feeding future frames (modeling_live.py:116-148)
                    last_stream_idx = int(sidx[-1])
                    if r == num_turns - 1:
                        frame_diff = 0
                    else:
                        nts, nte = starts[r + 1], stops[r + 1]
                        next_frames = int(
                            v_mask_all[nts:nte].sum()) // fnt
                        to_append = min(next_frames, turn_num_frames - 1)
                        if to_append <= 0:
                            frame_diff = 0
                        else:
                            frame_diff = self._rollforward(
                                cache, last_stream_idx + 1, frames,
                                past_num_frames + turn_num_frames, to_append,
                                frame_token_interval_threshold)
                frame_diffs.append(abs(frame_diff))

            if turn_lm.any() and turn_stream.any():
                n_v = int(turn_stream.sum())
                n_valid = lm_count + n_v
                if frame_diff == 0:
                    fluency = (n_v + num_lm_correct) / n_valid
                elif frame_diff > 0:
                    fluency = (n_v - frame_diff) / n_valid
                else:
                    fluency = (n_v - 1) / n_valid
                fluencies.append(fluency)
            past_num_frames += turn_num_frames

        return np.array([
            np.mean(lm_ppls) if lm_ppls else 1.0,
            np.mean(frame_diffs) if frame_diffs else 0.0,
            np.mean(fluencies) if fluencies else 1.0,
            np.mean(lm_corrects) if lm_corrects else 1.0,
        ], np.float32)

    @torch.no_grad()
    def _rollforward(self, cache, trim_to: int, frames, start_frame: int,
                     to_append: int, threshold: float) -> int:
        """Append future frames after rewinding the ring to ``trim_to``.
        Negative return = model fires late (modeling_live.py:128-148). The
        ring rows the append writes are saved first and put back after, so
        later turns see the ring as the prefill left it."""
        cfg = self.cfg
        fnt = cfg.frame_num_tokens
        unit = ([self.interval_id] if self.use_interval else []) + \
            [cfg.v_placeholder_id] * fnt
        append_ids = np.tile(unit, to_append)[None]
        append_frames = np.asarray(frames)[start_frame:start_frame + to_append]
        S = append_ids.shape[1]
        # the forward writes at its offset, clamped into the ring as
        # llama.forward clamps it
        start = min(max(trim_to, 0), cache.capacity - S)
        pools = [cache.k, cache.v] + ([cache.k_scale, cache.v_scale]
                                      if cache.quantized else [])
        saved = [pool[:, :, :, start:start + S].clone() for pool in pools]
        try:
            argmax, argmax_excl, p_int = _rollforward_stats(
                self.params, cfg, llama.trim_kv_cache(cache, trim_to),
                self._tensor(append_ids, torch.long),
                self._frames(append_frames), self.interval_id)
        finally:
            for pool, rows in zip(pools, saved):
                pool[:, :, :, start:start + S] = rows
        # gate only at the last token of each frame unit
        idxs = np.arange(len(unit) - 1, S, len(unit))
        fire = self._gate_fire_index(argmax[idxs], argmax_excl[idxs],
                                     p_int[idxs], threshold)
        if fire is not None:
            return -(fire + 1)
        return -to_append
