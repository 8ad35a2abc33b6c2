"""LiveLlama, the streaming video-dialogue model, in PyTorch.

Counterpart of ``videollm_online_tpu/models/live.py``: the connector
(Linear -> erf GELU -> Linear), ``joint_embed`` (the k-th ``<v>`` token in
flattened batch order takes the k-th projected frame token, a cumsum
gather), and the training forward with the weighted streaming CE loss of
reference modeling_live_llama.py:56-61 (weight ``stream_loss_weight`` on
``<v>`` positions, 1 elsewhere, over the count of supervised labels), whole
or streamed through lm_head chunks.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.config import LiveConfig
from ..core.device import resolve_device, torch_dtype
from ..parallel import collectives as coll
from ..parallel.context import ParallelContext
from ..parallel.mesh import MODEL_AXIS, current_mesh
from . import llama, quant

Params = Dict[str, Any]

IGNORE_INDEX = -100
# Positions per lm_head chunk of the streamed CE loss (the JAX package's
# LOSS_CHUNK): peak loss memory is about 2 x LOSS_CHUNK x vocab fp32.
LOSS_CHUNK = 1024


def init_connector(generator: torch.Generator, cfg: LiveConfig,
                   device=None) -> Params:
    """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights, zero biases, drawn
    from ``generator`` (which must live on ``device``)."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.llama.dtype)
    vh, d = cfg.vision_hidden_size, cfg.llama.hidden_size

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, device=device)
        return ((u * 2.0 - 1.0) * bound).to(dtype)

    return {
        "fc1": {"w": uniform((vh, d), 1.0 / np.sqrt(vh)),
                "b": torch.zeros((d,), dtype=dtype, device=device)},
        "fc2": {"w": uniform((d, d), 1.0 / np.sqrt(d)),
                "b": torch.zeros((d,), dtype=dtype, device=device)},
    }


def apply_connector(connector: Params, features: torch.Tensor) -> torch.Tensor:
    """(N, vision_hidden) -> (N, hidden); GELU is the exact erf form."""
    h = features @ connector["fc1"]["w"] + connector["fc1"]["b"]
    h = F.gelu(h, approximate="none")
    return h @ connector["fc2"]["w"] + connector["fc2"]["b"]


def visual_embed(params: Params, frames: torch.Tensor, cfg: LiveConfig
                 ) -> torch.Tensor:
    """Pre-extracted frame features (N, tokens_per_frame, vision_hidden) or
    (N*, vision_hidden) -> (N * tokens_per_frame, hidden)."""
    w = params["connector"]["fc1"]["w"]
    out = apply_connector(params["connector"],
                          frames.to(device=w.device, dtype=w.dtype))
    return out.reshape(-1, out.shape[-1])


def pixels_to_embeds(vision_params: Params, params: Params,
                     pixels: torch.Tensor, cfg: LiveConfig) -> torch.Tensor:
    """Raw uint8 frames (T, 3, H, W) -> per-frame LLM embeddings
    (T, frame_num_tokens, hidden): the SigLIP tower, then the connector
    (the reference's set_vision_inside path, modeling_live.py:12-27). Both
    serving engines' raw-pixel ingest runs it on the tower's device."""
    from . import siglip
    feats = siglip.frame_features(
        vision_params, siglip.preprocess(pixels, cfg.vision), cfg.vision,
        cfg)
    flat = visual_embed(params, feats, cfg)
    return flat.reshape(-1, cfg.frame_num_tokens, flat.shape[-1])


def init_params(generator: torch.Generator, cfg: LiveConfig, device=None
                ) -> Params:
    """Random decoder, connector and (when ``cfg.lora``) LoRA, drawn in
    that order from ``generator`` (which must live on ``device``)."""
    params = {"llama": llama.init_params(generator, cfg.llama, device),
              "connector": init_connector(generator, cfg, device)}
    if cfg.lora is not None:
        params["lora"] = llama.init_lora_params(generator, cfg.llama,
                                                cfg.lora, device)
    return params


def joint_embed(params: Params, cfg: LiveConfig, input_ids: torch.Tensor,
                frames: Optional[torch.Tensor] = None,
                v_offset: int = 0) -> torch.Tensor:
    """Text embeddings with frame embeddings put into the ``<v>`` slots:
    the k-th ``<v>`` in flattened (batch-major) order takes the k-th row of
    the flattened visual embeddings (clipped when the text has more ``<v>``
    slots than frames). Differentiable in the connector. A data shard of
    the batch passes ``v_offset``, the ``<v>`` count of the global rows
    before its own (``train.step.shard_batch``)."""
    embeds = llama.embed_tokens(params["llama"], input_ids, cfg.llama)
    if frames is None or frames.numel() == 0:
        return embeds
    visual = visual_embed(params, frames, cfg)
    B, T = input_ids.shape
    v_mask = (torch.as_tensor(input_ids).to(embeds.device).reshape(-1)
              == cfg.v_placeholder_id)
    v_idx = (torch.cumsum(v_mask, 0) - 1 + int(v_offset)).clamp(
        0, visual.shape[0] - 1)
    gathered = visual[v_idx].reshape(B, T, -1).to(embeds.dtype)
    return torch.where(v_mask.reshape(B, T)[..., None], gathered, embeds)


def _loss_weights(labels, input_ids, cfg: LiveConfig, device):
    flat_labels = torch.as_tensor(labels).to(device).reshape(-1).long()
    flat_ids = torch.as_tensor(input_ids).to(device).reshape(-1)
    valid = flat_labels != IGNORE_INDEX
    weight = torch.where(flat_ids == cfg.v_placeholder_id,
                         cfg.stream_loss_weight, 1.0)
    return valid, torch.where(valid, flat_labels, 0), weight


def _ce_sums(logits: torch.Tensor, labels, input_ids, cfg: LiveConfig):
    """(sum of weighted per-token losses, count of supervised tokens)."""
    V = logits.shape[-1]
    valid, safe, weight = _loss_weights(labels, input_ids, cfg, logits.device)
    logp = F.log_softmax(logits.reshape(-1, V).float(), dim=-1)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    nll = torch.where(valid, nll * weight, torch.zeros_like(nll))
    return nll.sum(), valid.sum()


def _mean(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, over the current mesh: the value is the global loss (the
    sums over every rank) and the gradient that of this rank's share,
    ``num / global den``, so the ranks' shares add up to the loss
    (``parallel/collectives.py``). A token held by R ranks is counted R
    times in both sums."""
    mesh = current_mesh()
    if mesh is None or mesh.size == 1:
        return num / den.clamp(min=1)
    num_all = coll.all_reduce(num.detach(), mesh, None)
    den_all = coll.all_reduce(den.detach().float(), mesh, None).clamp(min=1)
    share = num / den_all
    return share + (num_all / den_all - share).detach()


def stream_ce_loss(logits: torch.Tensor, labels, input_ids,
                   cfg: LiveConfig) -> torch.Tensor:
    """Weighted CE in fp32: the sum of weighted per-token losses over the
    number of supervised tokens; label -100 contributes 0."""
    return _mean(*_ce_sums(logits, labels, input_ids, cfg))


def _stream_ce_loss_chunked(params: Params, cfg: LiveConfig,
                            hidden: torch.Tensor, labels, input_ids, *,
                            lora: Optional[Params] = None,
                            scaling: float = 1.0,
                            dropout_seed: Optional[int] = None,
                            drop_rate: float = 0.0,
                            loss_chunk: Optional[int] = None,
                            rows=None, par=None) -> torch.Tensor:
    """``stream_ce_loss`` streamed through ``loss_chunk``-position lm_head
    chunks, each under ``torch.utils.checkpoint``, so neither pass holds
    more than one chunk's (C, V) logits. ``hidden`` is the decoder's
    final-norm output (B, T, D). Per-position math is the same fp32; only
    the order of the sum differs. With head dropout, chunk i's mask is
    seeded by ``fold_seed(fold_seed(dropout_seed, L), i)``: another
    realization than the unchunked draw, the same law. The chunks are
    those of the global batch: a batch or sequence shard (``rows``, as
    ``llama.forward``'s ``shard_rows``) groups its positions by the
    global chunk they fall in and cuts each chunk's mask from the global
    chunk's."""
    B, T, D = hidden.shape
    valid, safe, weight = _loss_weights(labels, input_ids, cfg, hidden.device)
    weight = torch.where(valid, weight, torch.zeros_like(weight)).float()
    N = B * T
    use_drop = (dropout_seed is not None and drop_rate > 0.0
                and (lora or {}).get("lm_head") is not None)
    head_seed = (llama.fold_seed(dropout_seed, cfg.llama.num_layers)
                 if use_drop else None)

    # an int8 head is applied a column tile at a time: one tile's cast
    # copy in each chunk's forward and backward, not the whole head's
    tile_cols = quant.head_tile_cols(cfg.llama.vocab_size)

    def chunk_weighted_nll(hc, lc, wc, seed, offsets):
        lg = llama.lm_head(params["llama"], hc, cfg.llama, lora=lora,
                           lora_scaling=scaling, drop_seed=seed,
                           drop_rate=drop_rate if seed is not None else 0.0,
                           drop_region=((C, D), (offsets, 0)), par=par,
                           tile_cols=tile_cols)
        logp = F.log_softmax(lg.float(), dim=-1)
        return (-logp.gather(1, lc[:, None])[:, 0] * wc).sum()

    b0, Bg, s0, Tg = rows if rows is not None else (0, B, 0, T)
    C = min(loss_chunk or LOSS_CHUNK, Bg * Tg)
    g = ((b0 + torch.arange(B))[:, None] * Tg + s0
         + torch.arange(T)[None]).reshape(-1)       # global flat positions
    h_flat = hidden.reshape(N, D)
    sums, r0 = [], 0
    for c, n in zip(*(t.tolist() for t in torch.unique_consecutive(
            g // C, return_counts=True))):
        r1 = r0 + n
        sums.append(checkpoint(
            chunk_weighted_nll, h_flat[r0:r1], safe[r0:r1], weight[r0:r1],
            llama.fold_seed(head_seed, c) if use_drop else None,
            (g[r0:r1] % C).to(hidden.device), use_reentrant=False))
        r0 = r1
    return _mean(torch.stack(sums).sum(), valid.sum())


def forward(params: Params, cfg: LiveConfig, input_ids=None, frames=None,
            inputs_embeds: Optional[torch.Tensor] = None, labels=None, *,
            remat: bool = False, attn_impl=None,
            dropout_seed: Optional[int] = None, chunked_loss: bool = False,
            loss_chunk: Optional[int] = None, shard=None,
            remat_group: int = 1
            ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The cache-free forward: (logits, loss or None). Labels arrive
    pre-shifted from the collator, so logits[t] is scored against
    labels[t]. LoRA dropout (``cfg.lora.dropout``) is on when
    ``dropout_seed`` is given. ``chunked_loss`` (needs labels) streams the
    CE through lm_head chunks and returns (None, loss). ``remat_group``
    groups the decoder's remat (``llama.forward``).

    Under a mesh: ``shard`` = (row start, global rows, ``<v>`` offset) of
    a data shard of the batch (``train.step.shard_batch``); with a
    sequence-parallel ``attn_impl`` the model axis carries the sequence:
    the joint embedding is made whole, each rank keeps its T/N positions
    (logits and loss over those), and the loss is the global one
    (``_mean``)."""
    b0, Bg, v_offset = (0, None, 0) if shard is None else \
        (int(shard[0]), int(shard[1]), int(shard[2]))
    if inputs_embeds is None:
        inputs_embeds = joint_embed(params, cfg, input_ids, frames, v_offset)
    B, T = inputs_embeds.shape[:2]
    rows = None if shard is None else (b0, Bg, 0, T)
    positions = None
    par = ParallelContext.current(cfg.llama, attn_impl)
    if par is not None and par.sp:
        n, i = par.mesh.shape[MODEL_AXIS], par.mesh.coord(MODEL_AXIS)
        if T % n:
            raise ValueError(f"sequence parallel: length {T} does not "
                             f"split over model={n}")
        t = T // n
        inputs_embeds = inputs_embeds[:, i * t:(i + 1) * t]
        positions = torch.arange(i * t, (i + 1) * t,
                                 dtype=torch.int32)[None].expand(B, t)
        if labels is not None:
            labels = torch.as_tensor(labels)[:, i * t:(i + 1) * t]
            input_ids = torch.as_tensor(input_ids)[:, i * t:(i + 1) * t]
        rows = (b0, Bg or B, i * t, T)
    lora = params.get("lora")
    on = cfg.lora is not None and lora is not None
    scaling = cfg.lora.scaling if on else 1.0
    lora_dropout = cfg.lora.dropout if on else 0.0
    kw = dict(cfg=cfg.llama, inputs_embeds=inputs_embeds, lora=lora,
              lora_scaling=scaling, remat=remat, attn_impl=attn_impl,
              dropout_seed=dropout_seed, lora_dropout=lora_dropout,
              positions=positions, shard_rows=rows, remat_group=remat_group)
    if chunked_loss:
        if labels is None:
            raise ValueError("chunked_loss needs labels")
        hidden, _ = llama.forward(params["llama"], return_hidden=True, **kw)
        head_params = params
        if par is not None:
            # the head's gathered shards, once for every chunk
            name = "embed" if cfg.llama.tie_word_embeddings else "lm_head"
            head_params = dict(params, llama=dict(
                params["llama"], **{name: par.weight(params["llama"][name],
                                                     name)}))
        return None, _stream_ce_loss_chunked(
            head_params, cfg, hidden, labels, input_ids, lora=lora,
            scaling=scaling, dropout_seed=dropout_seed,
            drop_rate=lora_dropout, loss_chunk=loss_chunk, rows=rows,
            par=par)
    logits, _ = llama.forward(params["llama"], **kw)
    loss = (None if labels is None
            else stream_ce_loss(logits, labels, input_ids, cfg))
    return logits, loss
