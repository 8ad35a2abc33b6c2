"""Offline-benchmark generation: greedy-from-embeds and beam search.

Counterpart of ``videollm_online_tpu/eval/generation.py``, the reference's
two generate evaluators (engine/trainer_with_gen2eval.py:5-21):
  * ``generate_after_embed``: greedy decode from the jointly embedded
    prompt (COIN; modeling_live_llama.py:69-70, do_sample=False);
  * ``generate``: beam search (LTA; 5 beams, 512 new tokens,
    num_return_sequences=5, data/ego4d/lta.py:13).

Beam search follows HF semantics (length_penalty=1.0, early_stopping=False):
scores are summed log-probs; finished hypotheses freeze when EOS tops a
beam; search stops when the worst kept hypothesis can no longer be beaten.
Each step is one forward of the (num_beams,) batch over a shared KV ring,
whose rows are reordered along the beam axis in place first. The JAX
package runs the search as one device loop (``_beam_search_loop``) beside
its host loop; here ``search`` is the host loop, and ``search_host`` names
the same function. Decode steps attend through ``ops.auto.auto_attention``:
the ring decode kernel K1 on the card, the plain attention on the CPU (an
``attn_impl`` given by the caller, such as the plain ``llama._attention``,
takes its place: chip_smoke.py holds the kernel route against it).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import LiveConfig
from ..models import generate as gen_mod
from ..models import live, llama
from ..ops.auto import auto_attention
from ..train.optim import tree_leaves


def _round_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _inputs(params, input_ids, frames):
    """(input_ids, frames) as tensors on the params' device (frames None
    when there are none)."""
    device = tree_leaves(params["llama"])[0].device
    ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                          device=device)
    if frames is None or not np.size(frames):
        return ids, None
    return ids, torch.as_tensor(np.asarray(frames), dtype=torch.float32,
                                device=device)


@torch.no_grad()
def greedy_from_embeds(params, cfg: LiveConfig, input_ids: np.ndarray,
                       frames: Optional[np.ndarray], *,
                       max_new_tokens: int = 512,
                       capacity: Optional[int] = None,
                       num_valid: Optional[int] = None,
                       attn_impl=None) -> np.ndarray:
    """generate_after_embed equivalent: returns generated ids (1, L).
    ``num_valid`` < T marks right-padding (bucketed eval batches): pads are
    appended but never advance the ring nor feed the gate."""
    T = input_ids.shape[1]
    capacity = capacity or _round_up(T + max_new_tokens + 8,
                                     BeamSearcher.CAPACITY_BUCKET)
    ids, frames = _inputs(params, input_ids, frames)
    cache = llama.init_kv_cache(cfg.llama, batch=1, capacity=capacity,
                                device=ids.device)
    embeds = live.joint_embed(params, cfg, ids, frames)
    out, length, _ = gen_mod.greedy_generate(
        params, cfg, cache, embeds, torch.tensor([num_valid or T]),
        max_new_tokens=max_new_tokens, attn_impl=attn_impl or auto_attention)
    return out.numpy()[:, :int(length[0])]


class BeamSearcher:
    """``CAPACITY_BUCKET`` rounds the ring's capacity up as the JAX package
    does (where it bounds recompiles), so capacities and positions match."""

    CAPACITY_BUCKET = 128

    def __init__(self, params, cfg: LiveConfig, num_beams: int = 5,
                 attn_impl=None):
        self.params = params
        self.cfg = cfg
        self.K = num_beams
        self.attn_impl = attn_impl or auto_attention
        lora = params.get("lora")
        self.scaling = (cfg.lora.scaling
                        if (cfg.lora is not None and lora is not None)
                        else 1.0)

    def _forward(self, embeds, cache, **kw):
        return llama.forward(
            self.params["llama"], cfg=self.cfg.llama, inputs_embeds=embeds,
            kv_cache=cache, lora=self.params.get("lora"),
            lora_scaling=self.scaling, attn_impl=self.attn_impl, **kw)

    def _embed_and_prefill(self, input_ids, frames, num_valid,
                           max_new_tokens):
        """The prompt appended to all K rows of a fresh ring: ((K, V) fp32
        log-probs at the last valid position, cache)."""
        cfg, K = self.cfg, self.K
        T = input_ids.shape[1]
        capacity = _round_up(T + max_new_tokens + 8, self.CAPACITY_BUCKET)
        ids, frames = _inputs(self.params, input_ids, frames)
        cache = llama.init_kv_cache(cfg.llama, batch=K, capacity=capacity,
                                    device=ids.device)
        embeds = live.joint_embed(self.params, cfg, ids, frames)
        embeds = embeds.expand((K,) + embeds.shape[1:])
        nv = torch.full((K,), num_valid or T, dtype=torch.int32)
        logits, cache = self._forward(embeds, cache, num_valid=nv,
                                      logit_gather_positions=nv - 1)
        return F.log_softmax(logits[:, 0].float(), dim=-1), cache

    def _reorder_and_step(self, tokens, cache, parents):
        """Reorder the ring along the beam axis by ``parents`` (in place,
        over the slots written so far), then append one token per beam:
        ((K, V) fp32 log-probs, cache)."""
        n = int(cache.offset.max())
        if not torch.equal(parents, torch.arange(self.K)):
            idx = parents.to(cache.k.device)
            pools = [cache.k, cache.v] + ([cache.k_scale, cache.v_scale]
                                          if cache.quantized else [])
            for pool in pools:
                pool[:, :, :, :n] = pool[:, :, :, :n].index_select(1, idx)
            cache = cache.replace(offset=cache.offset[parents],
                                  pos_base=cache.pos_base[parents])
        embeds = llama.embed_tokens(self.params["llama"], tokens[:, None],
                                    self.cfg.llama)
        logits, cache = self._forward(embeds, cache)
        return F.log_softmax(logits[:, -1].float(), dim=-1), cache

    @torch.no_grad()
    def search(self, input_ids: np.ndarray, frames: Optional[np.ndarray], *,
               max_new_tokens: int = 512, num_return_sequences: int = None,
               length_penalty: float = 1.0,
               num_valid: Optional[int] = None) -> List[np.ndarray]:
        """input_ids: (1, T) prompt. Returns ``num_return_sequences``
        generated-id arrays (EOS included when produced), best first: the
        JAX package's ``search`` and ``search_host`` results. One forward
        and one (K, V) log-prob readback per token; the scores are summed
        in float64 on the host, as the JAX host loop sums them."""
        cfg, K = self.cfg, self.K
        n_ret = num_return_sequences or K
        eos = cfg.eos_token_id
        logp, cache = self._embed_and_prefill(input_ids, frames, num_valid,
                                              max_new_tokens)
        cur_logp = logp.cpu().numpy()   # (K, V): identical rows

        beam_scores = np.full((K,), -1e9, np.float64)
        beam_scores[0] = 0.0
        beam_tokens: List[List[int]] = [[] for _ in range(K)]
        finished: List[Tuple[float, List[int]]] = []

        for step_i in range(max_new_tokens):
            total = beam_scores[:, None] + cur_logp.astype(np.float64)
            flat = total.reshape(-1)
            top = np.argpartition(-flat, 2 * K)[: 2 * K]
            top = top[np.argsort(-flat[top])]
            next_parents, next_tokens, next_scores = [], [], []
            for rank, cand in enumerate(top):
                parent, tok = divmod(int(cand), total.shape[1])
                score = float(flat[cand])
                if tok == eos:
                    # HF: EOS candidates beyond rank K are dropped; the
                    # length includes the eos (BeamSearchScorer.process)
                    if rank < K:
                        denom = (step_i + 1) ** length_penalty
                        finished.append((score / denom,
                                         beam_tokens[parent] + [tok]))
                else:
                    next_parents.append(parent)
                    next_tokens.append(tok)
                    next_scores.append(score)
                if len(next_parents) == K:
                    break
            # HF stopping: done when the best possible remaining score
            # can't beat the worst kept finished hypothesis
            if len(finished) >= K:
                best_possible = float(total.max()) / (
                    (step_i + 1) ** length_penalty)
                worst_kept = sorted(finished, key=lambda x: -x[0])[K - 1][0]
                if worst_kept >= best_possible:
                    break
            beam_tokens = [beam_tokens[p] + [t]
                           for p, t in zip(next_parents, next_tokens)]
            beam_scores = np.asarray(next_scores, np.float64)
            logp, cache = self._reorder_and_step(
                torch.tensor(next_tokens, device=cache.k.device),
                cache, torch.tensor(next_parents))
            cur_logp = logp.cpu().numpy()

        # finalize open beams (budget exhausted)
        for score, toks in zip(beam_scores, beam_tokens):
            finished.append((score / (max(len(toks), 1) ** length_penalty),
                             list(toks)))
        finished.sort(key=lambda x: -x[0])
        return [np.asarray(toks, np.int64)
                for _, toks in finished[:n_ret]]

    search_host = search


def beam_generate(params, cfg: LiveConfig, input_ids, frames, *,
                  num_beams: int = 5, max_new_tokens: int = 512,
                  num_return_sequences: int = None,
                  num_valid: Optional[int] = None, **kwargs) -> np.ndarray:
    """'generate' evaluator: (num_return_sequences, L) padded with -100 to a
    common length (the trainer gathers fixed-width rows)."""
    searcher = BeamSearcher(params, cfg, num_beams)
    seqs = searcher.search(np.asarray(input_ids), frames,
                           max_new_tokens=max_new_tokens,
                           num_return_sequences=num_return_sequences,
                           num_valid=num_valid)
    L = max((len(s) for s in seqs), default=1)
    out = np.full((len(seqs), max(L, 1)), -100, np.int64)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out
