"""Response generation over the static KV ring, in PyTorch.

Counterpart of ``videollm_online_tpu/models/generate.py``. The JAX package
runs the decode as one on-device ``while_loop``; here it is a host loop of
forwards that reads one token (or one verify step's predictions) back per
iteration to decide whether to stop.

Semantics are the JAX package's: generated tokens are fed back except the
final one (EOS or the budget-limited last token), whose KV is NOT in the
cache — the serving loop feeds it with the next frame append.

The n-gram history ring (``hist``, ``count``) is host bookkeeping: int32
CPU tensors, so drafting costs no device round trip.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.config import LiveConfig
from . import llama
from .llama import KVCache

Params = Dict[str, Any]

SPEC_HIST = 2048   # token-history ring length
SPEC_DRAFT = 7     # default drafted tokens per verify step


def _forward_fn(params: Params, cfg: LiveConfig, attn_impl):
    lora = params.get("lora")
    scaling = (cfg.lora.scaling if (cfg.lora is not None and lora is not None)
               else 1.0)
    return functools.partial(llama.forward, params["llama"], cfg=cfg.llama,
                             lora=lora, lora_scaling=scaling,
                             attn_impl=attn_impl)


def _prompt_forward(fwd, cache, prompt_embeds, num_valid):
    nv = torch.as_tensor(num_valid, dtype=torch.int32).cpu().reshape(-1)
    logits, cache = fwd(inputs_embeds=prompt_embeds, kv_cache=cache,
                        num_valid=nv,
                        logit_gather_positions=torch.clamp(nv - 1, min=0))
    return int(torch.argmax(logits[0, 0], dim=-1)), cache


def greedy_generate(
    params: Params,
    cfg: LiveConfig,
    cache: KVCache,
    prompt_embeds: torch.Tensor,
    num_valid,
    *,
    max_new_tokens: Optional[int] = None,
    attn_impl=None,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """Append ``prompt_embeds`` (B=1, S, D; ``num_valid`` real tokens) and
    greedy-decode. Returns (output_ids (1, max_new) int32, length (1,),
    cache); the ring is written in place."""
    max_new = max_new_tokens or cfg.max_response_tokens
    fwd = _forward_fn(params, cfg, attn_impl)
    tok, cache = _prompt_forward(fwd, cache, prompt_embeds, num_valid)
    out = torch.zeros((1, max_new), dtype=torch.int32)
    out[0, 0] = tok
    i = 1
    while i < max_new and tok != cfg.eos_token_id:
        emb = llama.embed_tokens(params["llama"], out[:, i - 1:i], cfg.llama)
        logits, cache = fwd(inputs_embeds=emb, kv_cache=cache)
        tok = int(torch.argmax(logits[0, -1], dim=-1))
        out[0, i] = tok
        i += 1
    return out, torch.tensor([i], dtype=torch.int32), cache


def hist_append_ids(hist: torch.Tensor, count, ids: torch.Tensor, n
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append the first ``n`` of ``ids`` (1-D, valid-first) to the history
    ring (in place); past the ring's length the newest tokens win. Returns
    (hist, count + n)."""
    H = hist.shape[0]
    n = int(n)
    count = int(count)
    new = torch.as_tensor(ids).reshape(-1)[:n].to(torch.int32).cpu()
    if n > H:
        new = new[n - H:]
    if n > 0:
        hist[(count + n - len(new) + torch.arange(len(new))) % H] = new
    return hist, torch.tensor(count + n, dtype=torch.int32)


def _ngram_draft(hist: torch.Tensor, count, draft_len: int) -> torch.Tensor:
    """Draft ``draft_len`` tokens: what followed the most recent earlier
    occurrence of the current 3-gram suffix (2-gram fallback) in the
    history ring. No match -> zeros (verification rejects them)."""
    H = hist.shape[0]
    c = int(count)
    s0, s1, s2 = (hist[(c - j) % H] for j in (1, 2, 3))
    age = torch.arange(1, H + 1)            # candidate end g = c - 1 - age
    g = c - 1 - age
    lo = max(c - H, 0)                       # oldest retained global index
    v0, v1, v2 = hist[g % H], hist[(g - 1) % H], hist[(g - 2) % H]
    ok2 = (g - 1 >= lo) & (v0 == s0) & (v1 == s1) & (c >= 2)
    ok3 = ok2 & (g - 2 >= lo) & (v2 == s2) & (c >= 3)
    big = H + 1
    a3 = int(torch.where(ok3, age, big).min())
    a2 = int(torch.where(ok2, age, big).min())
    a_sel = a3 if a3 <= H else a2
    if a_sel > H:
        return torch.zeros((draft_len,), dtype=torch.int32)
    src = c - a_sel + torch.arange(draft_len)    # g_sel + 1 + k
    valid = (src <= c - 1) & (src >= lo)
    return torch.where(valid, hist[src % H], 0).to(torch.int32)


def ngram_speculative_generate(
    params: Params,
    cfg: LiveConfig,
    cache: KVCache,
    prompt_embeds: torch.Tensor,
    num_valid,
    hist: torch.Tensor,
    hist_count,
    *,
    prompt_ids: Optional[torch.Tensor] = None,
    prompt_n=None,
    max_new_tokens: Optional[int] = None,
    draft_len: int = SPEC_DRAFT,
    draft_mode: str = "ngram",
    attn_impl=None,
    forced_ids: Optional[torch.Tensor] = None,
):
    """``greedy_generate`` with n-gram speculative verification: the same
    token stream, length and cache invariant, up to ``draft_len + 1``
    tokens per forward. ``draft_mode="zero"`` drafts constant zeros (the
    adversarial worst case). ``forced_ids`` ((max_new,) int32) replays a
    script: the token emitted at index i is ``forced_ids[i]`` instead of
    the argmax, while every forward and acceptance comparison runs as
    before (acceptance is a property of the emitted stream, so a script of
    narration-like text measures the tokens per verify step a trained
    model would see; pad a row with EOS to end it early). Returns
    (output_ids (1, max_new), length (1,), cache, hist, hist_count, stats)
    with stats = [verify_steps, emitted]."""
    if draft_mode not in ("ngram", "zero"):
        raise ValueError(f"draft_mode {draft_mode!r}")
    max_new = max_new_tokens or cfg.max_response_tokens
    K = draft_len
    eos = cfg.eos_token_id
    fwd = _forward_fn(params, cfg, attn_impl)
    if prompt_ids is not None:
        pn = prompt_ids.shape[-1] if prompt_n is None else int(prompt_n)
        hist, hist_count = hist_append_ids(hist, hist_count,
                                           prompt_ids.reshape(-1), pn)

    first, cache = _prompt_forward(fwd, cache, prompt_embeds, num_valid)
    if forced_ids is not None:
        forced_ids = torch.as_tensor(forced_ids, dtype=torch.int32).cpu()
        first = int(forced_ids[0])
    out = torch.zeros((1, max_new), dtype=torch.int32)
    out[0, 0] = first
    hist, hist_count = hist_append_ids(hist, hist_count,
                                       torch.tensor([first]), 1)
    i, steps, done = 1, 1, first == eos
    gather = torch.arange(K + 1, dtype=torch.int32)[None]
    while i < max_new and not done:
        drafts = (torch.zeros((K,), dtype=torch.int32) if draft_mode == "zero"
                  else _ngram_draft(hist, hist_count, K))
        toks = torch.cat([out[0, i - 1:i], drafts])[None]
        emb = llama.embed_tokens(params["llama"], toks, cfg.llama)
        off0 = cache.offset
        logits, cache = fwd(inputs_embeds=emb, kv_cache=cache,
                            num_valid=torch.tensor([K + 1], dtype=torch.int32),
                            logit_gather_positions=gather)
        preds = torch.argmax(logits[0], dim=-1).to(torch.int32).cpu()
        if forced_ids is not None:
            preds = forced_ids[torch.clamp(i + torch.arange(K + 1), 0,
                                           max_new - 1)]
        mism = (preds[:K] != drafts).nonzero()
        emit = (int(mism[0]) if len(mism) else K) + 1   # preds[0..accepted]
        eos_at = (preds[:emit] == eos).nonzero()
        done = len(eos_at) > 0
        if done:
            emit = int(eos_at[0]) + 1
        emit = min(emit, max_new - i)                    # budget clip
        out[0, i:i + emit] = preds[:emit]
        hist, hist_count = hist_append_ids(hist, hist_count, preds, emit)
        # keep KV for [prev, d0..d_{emit-2}]; the newest emitted token's KV
        # stays out of the cache (invariant)
        cache = cache.replace(offset=off0 + emit)
        i += emit
        steps += 1
    stats = torch.tensor([steps, i], dtype=torch.int32)
    return (out, torch.tensor([i], dtype=torch.int32), cache, hist,
            hist_count, stats)
