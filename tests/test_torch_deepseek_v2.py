"""The port's DeepSeek-V2 decoder (``models/deepseek_v2.py``) against the
benchmark's plain fp32 reference (``portbench/reference/deepseek_v2.py``,
the published, non-absorbed equations) on seeded random weights, at a tiny
size on the CPU: 3 layers (layer 0 dense), 8 routed experts top-2 and 2
shared, yarn rope active on the rope dims.

Both sides compute in fp32 here, in another order (the port's absorbed
attention and latent cache, the reference's per-head keys and values), so
logits agree to about 1e-5 of their size; the tolerances below are stated
with each test. On the CPU the latent attention is the kernel's plain
version, the expert products a loop over the experts.
"""

import time

import numpy as np
import pytest
import torch

from portbench import run
from portbench.reference import deepseek_v2 as ref
from portbench.tests import _tiny
from videollm_online_tpu_torch.core.config import DeepseekV2Config, LiveConfig
from videollm_online_tpu_torch.models import deepseek_v2 as ds
from videollm_online_tpu_torch.models import live
from videollm_online_tpu_torch.ops import mla_attention as ma
from videollm_online_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                     Mesh, maybe_mesh)
from videollm_online_tpu_torch.serve.multistream import MultiStreamEngine
from videollm_online_tpu_torch.tokenizer.live_tokenizer import LiveTokenizer
from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer

SEED = 2 ** 31 + 21


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(vocab_size=97, hidden_size=32, intermediate_size=48,
                moe_intermediate_size=16, num_layers=3, num_heads=4,
                kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
                v_head_dim=8, n_routed_experts=8, n_shared_experts=2,
                num_experts_per_tok=2, rope_original_max_position=16,
                dtype="float32")
    base.update(kw)
    return DeepseekV2Config(**base)


def _ref_cfg(cfg):
    """The configuration file's keys the reference reads, from ``cfg``."""
    return dict(
        num_attention_heads=cfg.num_heads,
        qk_nope_head_dim=cfg.qk_nope_head_dim,
        qk_rope_head_dim=cfg.qk_rope_head_dim, v_head_dim=cfg.v_head_dim,
        kv_lora_rank=cfg.kv_lora_rank, rope_theta=cfg.rope_theta,
        rope_scaling=dict(
            factor=cfg.rope_factor,
            original_max_position_embeddings=cfg.rope_original_max_position,
            beta_fast=cfg.rope_beta_fast, beta_slow=cfg.rope_beta_slow,
            mscale=cfg.rope_mscale, mscale_all_dim=cfg.rope_mscale_all_dim),
        rms_norm_eps=cfg.rms_norm_eps,
        first_k_dense_replace=cfg.first_k_dense_replace,
        num_experts_per_tok=cfg.num_experts_per_tok,
        norm_topk_prob=cfg.norm_topk_prob,
        routed_scaling_factor=cfg.routed_scaling_factor,
        num_hidden_layers=cfg.num_layers,
        moe_intermediate_size=cfg.moe_intermediate_size)


def _params(cfg, seed=0):
    return ds.init_params(torch.Generator().manual_seed(seed), cfg, "cpu",
                          std=0.3)


def _ref_logits(p, cfg, ids):
    """(len(ids), V) logits of the reference's full forward over ids."""
    h = ref.final_hidden(p, _ref_cfg(cfg), [ref.embed_ids(p, ids)])[0]
    return ref.logits(p, h)


def test_yarn_is_active_and_scale_is_published():
    cfg = _cfg()
    inv = ds.yarn_inv_freq(cfg, "cpu")
    d, base = cfg.qk_rope_head_dim, cfg.rope_theta
    extra = 1.0 / base ** (torch.arange(0, d, 2).float() / d)
    # the first frequency extrapolated, the others interpolated by 40
    assert torch.allclose(inv[:1], extra[:1])
    assert torch.allclose(inv[1:], extra[1:] / cfg.rope_factor)
    # DeepSeek-V2-Lite's 192^-0.5 (0.1 . 0.707 ln 40 + 1)^2
    assert DeepseekV2Config().softmax_scale == pytest.approx(0.11472, abs=1e-5)
    assert cfg.softmax_scale == pytest.approx(ref.softmax_scale(_ref_cfg(cfg)))


@pytest.mark.parametrize("norm_topk_prob", [False, True])
def test_full_forward_matches_reference(norm_topk_prob):
    """The cache-free forward (through a pool of its own) against the
    reference's, every position; atol 1e-4 on logits of size about 6: the
    same fp32 arithmetic in another order."""
    cfg = _cfg(norm_topk_prob=norm_topk_prob)
    p = _params(cfg)
    ids = torch.randint(0, cfg.vocab_size, (2, 20),
                        generator=torch.Generator().manual_seed(1))
    got, cache = ds.forward(p, cfg=cfg, input_ids=ids)
    assert cache is None
    for b in range(2):
        want = _ref_logits(p, cfg, ids[b])
        assert want.abs().max() > 1.0
        torch.testing.assert_close(got[b], want, atol=1e-4, rtol=1e-4)


def test_paged_prefill_then_decode_matches_reference():
    """Two streams on shuffled pages of 8 slots: a padded prefill chunk
    (13 and 9 real tokens), then 1-token decode forwards through the latent
    cache, one with stream 1 idle; each real position's logits against
    the reference's full forward of the stream's sequence (atol 1e-4, as
    above)."""
    cfg = _cfg()
    p = _params(cfg, seed=2)
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
    cache = ds.init_paged_kv_cache(cfg, 2, pool_pages=9, pages_per_stream=4,
                                   page_size=8, device="cpu")
    table = (torch.randperm(8, generator=g) + 1).view(2, 4).to(torch.int32)
    cache = cache.replace(table=table)
    emb = ds.embed_tokens(p, ids, cfg)
    got = [[], []]
    nv0 = [13, 9]
    chunk = emb[:, :13].clone()
    chunk[1, 9:] = 7.0                  # padding: must change nothing
    lg, cache = ds.forward(p, cfg=cfg, inputs_embeds=chunk, kv_cache=cache,
                           num_valid=torch.tensor(nv0))
    for b in range(2):
        got[b].extend(lg[b, :nv0[b]])
    pos = list(nv0)
    for step in range(8):
        live_ = [1, 0 if step == 3 else 1]
        x = torch.stack([emb[b, pos[b]] if live_[b] else emb[b, 0]
                         for b in range(2)])[:, None]
        lg, cache = ds.forward(p, cfg=cfg, inputs_embeds=x, kv_cache=cache,
                               num_valid=torch.tensor(live_))
        for b in range(2):
            if live_[b]:
                got[b].append(lg[b, 0])
                pos[b] += 1
    assert cache.offset.tolist() == pos
    for b in range(2):
        want = _ref_logits(p, cfg, ids[b, :pos[b]])
        torch.testing.assert_close(torch.stack(got[b]), want, atol=1e-4,
                                   rtol=1e-4)
    # the expert layers counted every real token, two experts each
    calls, pairs, peak = cache.moe_counts.tolist()
    assert calls == 2 * 9 and pairs == 2 * 2 * sum(pos)
    assert 0 < peak <= pairs


def test_absorbed_attention_equals_published():
    """One layer's attention: the port's absorbed form (latent rows in the
    pool, W_UK folded into the query, W_UV after the latent output)
    against the published form written with the reference's functions
    (per-head keys and values expanded through W_kv_b); atol 1e-5 on
    outputs of about unit size."""
    cfg = _cfg()
    c = _ref_cfg(cfg)
    p = _params(cfg, seed=4)
    T = 17
    h = torch.randn(1, T, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(5))
    lp = {k: v[1] for k, v in p["layers"].items()}
    cache = ds.init_paged_kv_cache(cfg, 1, pool_pages=4, pages_per_stream=3,
                                   page_size=8, device="cpu")
    cache = cache.replace(table=torch.tensor([[3, 1, 2]], dtype=torch.int32))
    pos = torch.arange(T, dtype=torch.int32)[None]
    phys, row = ds.paged_slots(cache.table, cache.offset, 8, T,
                               torch.tensor([T]))
    idx = {"phys": phys, "row": row, "table": cache.table, "attn_pos": pos,
           "nvalid": torch.tensor([T], dtype=torch.int32)}
    cos, sin = ds.rope_cos_sin(pos, cfg)
    got = ds._mla(h, lp, cfg, cos, sin, cache, idx, 1)[0]

    H, dn, dr, dv, R = 4, 8, 8, 8, 16
    w = {k: v.float() for k, v in lp.items()}
    x = ref.rms(h[0], w["attn_norm"], cfg.rms_norm_eps)
    q = (x @ w["wq"]).reshape(T, H, dn + dr)
    kv = x @ w["wkv_a"]
    kvb = (ref.rms(kv[:, :R], w["kv_norm"], cfg.rms_norm_eps)
           @ w["wkv_b"]).reshape(T, H, dn + dv)
    rc, rs = ref.yarn_cos_sin(c, torch.arange(T))
    k = torch.cat([kvb[..., :dn],
                   ref.rope(kv[:, None, R:], rc, rs).expand(T, H, dr)], -1)
    q = torch.cat([q[..., :dn], ref.rope(q[..., dn:], rc, rs)], -1)
    want = ref.attend(q, k, kvb[..., dn:], ref.softmax_scale(c)) @ w["wo"]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _gather_and_mask(q, latent, table, q_pos, layer, nvalid, scale, dv,
                     window):
    """Latent attention one query row at a time: the visible slots looked
    up page by page, their rows scored, softmaxed, averaged."""
    B, S, H, _ = q.shape
    page = latent.shape[2]
    out = torch.zeros(B, S, H, dv)
    for b in range(B):
        for s in range(int(nvalid[b])):
            p = int(q_pos[b, s])
            slots = [j for j in range(p + 1)
                     if window is None or j > p - window]
            rows = torch.stack([latent[layer, int(table[b, j // page]),
                                       j % page].float() for j in slots])
            for hh in range(H):
                w = torch.softmax(rows @ q[b, s, hh].float() * scale, 0)
                out[b, s, hh] = w @ rows[:, :dv]
    return out


@pytest.mark.parametrize("window", [None, 5])
def test_plain_latent_attention_matches_gather_and_mask(window):
    """The kernel's plain version against a row-at-a-time gather and
    mask (padding queries and a stream with none output 0); atol 1e-5,
    both fp32."""
    g = torch.Generator().manual_seed(6)
    B, S, H, dk, dv, page, maxp = 3, 5, 2, 12, 8, 4, 4
    latent = torch.randn(2, B * maxp + 1, page, dk, generator=g)
    table = (torch.randperm(B * maxp, generator=g) + 1).view(B, maxp).to(
        torch.int32)
    q = torch.randn(B, S, H, dk, generator=g)
    q_pos = torch.tensor([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11],
                          [3, 4, 5, 6, 7]], dtype=torch.int32)
    nvalid = torch.tensor([5, 3, 0], dtype=torch.int32)
    got = ma.mla_attention_reference(q, latent, table, q_pos, 1, nvalid,
                                     scale=0.3, dv=dv, window=window)
    want = _gather_and_mask(q, latent, table, q_pos, 1, nvalid, 0.3, dv,
                            window)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert not got[1, 3:].any() and not got[2].any()


def test_kernel_splits_follow_the_shapes():
    # a decode forward (one row block a stream) splits its slots; an
    # ingest of 64 streams of 88 queries fills the card with row blocks
    assert ma.num_splits(64, 16, 14336) == ma.MAX_SPLITS
    assert ma.num_splits(64, 88 * 16, 14336) == 1
    assert ma.num_splits(2, 30 * 16, 14336) > 1
    assert ma.num_splits(1, 16, 64) == 1


@pytest.mark.parametrize("norm_topk_prob", [False, True])
def test_routing_topk_plus_shared_experts(norm_topk_prob):
    """The expert layer against every expert computed on every token:
    each real token takes its top-2 experts by the fp32 softmax of the
    gate, weighted by their scores (renormalised only with
    ``norm_topk_prob``), plus the shared experts; a padding token gets the
    shared experts alone. The counts are [1, pairs, busiest expert's];
    atol 1e-5, fp32."""
    cfg = _cfg(norm_topk_prob=norm_topk_prob)
    p = _params(cfg, seed=7)
    mp = {k: v[0] for k, v in p["moe"].items()}
    T, Fe = 30, cfg.moe_intermediate_size
    x = torch.randn(T, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(8))
    valid = torch.arange(T) % 5 != 2
    counts = torch.zeros(3, dtype=torch.int64)
    got = ds.moe(x, mp, cfg, valid, counts)

    def swiglu(x, wg, wu, wd):
        return (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd

    scores = torch.softmax(x @ mp["gate"], -1)
    top = scores.topk(2, dim=-1)
    every = torch.stack([swiglu(x, mp["w_gate_up"][e][:, :Fe],
                                mp["w_gate_up"][e][:, Fe:],
                                mp["w_down"][e]) for e in range(8)], 1)
    w = top.values / (top.values.sum(-1, keepdim=True)
                      if norm_topk_prob else 1.0)
    routed = (every.gather(1, top.indices[..., None].expand(-1, -1, 32))
              * w[..., None]).sum(1)
    want = torch.where(valid[:, None], routed, 0) + swiglu(
        x, mp["s_gate"], mp["s_up"], mp["s_down"])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    if not norm_topk_prob:
        assert (top.values.sum(-1) < 0.99).all()   # no renormalisation
    per = torch.bincount(top.indices[valid].reshape(-1), minlength=8)
    assert counts.tolist() == [1, int(per.sum()), int(per.max())]


def _live(cfg0):
    cfg = LiveConfig(llama=cfg0, lora=None, vision_hidden_size=16)
    tok = LiveTokenizer(ByteTokenizer(), cfg)
    return tok.cfg.replace(max_response_tokens=6, gate_logit_bias=60.0), tok


def test_refusals():
    cfg0 = _cfg(vocab_size=512)
    cfg, tok = _live(cfg0)
    params = {"llama": _params(cfg0),
              "connector": live.init_connector(torch.Generator(), cfg, "cpu")}
    with pytest.raises(ValueError, match="LoRA"):
        ds.forward(params["llama"], cfg=cfg0, input_ids=torch.zeros(1, 2,
                   dtype=torch.long), lora={"layers": {}})
    with pytest.raises(ValueError, match="ring"):
        MultiStreamEngine(params, tok, cfg, num_streams=2, kv_capacity=256,
                          paged=False, device="cpu")
    with pytest.raises(ValueError, match="quant"):
        MultiStreamEngine(params, tok, cfg, num_streams=2, kv_capacity=256,
                          page_size=16, kv_quant="int8", device="cpu")
    # a mesh of two ranks (no process group is reached before the refusal)
    two = Mesh(None, {DATA_AXIS: 1, MODEL_AXIS: 2}, "cpu", None)
    with maybe_mesh(two), pytest.raises(ValueError, match="parallelism"):
        MultiStreamEngine(params, tok, cfg, num_streams=2, kv_capacity=256,
                          page_size=16, device="cpu")


def test_engine_prefix_page_copy_and_close():
    """MultiStreamEngine over the latent pool, two streams: the first
    admission prefills and keeps the system prompt's pages as the prefix
    template (its partial tail page copied); after ``close_stream`` the
    stream's pages return to the pool and its next dialogue is admitted
    from the template, whose rows it then holds bit for bit; the pool's
    invariants hold (``stats()``) and the expert layers are counted."""
    cfg0 = _cfg(vocab_size=512)
    cfg, tok = _live(cfg0)
    g = torch.Generator().manual_seed(9)
    params = {"llama": ds.init_params(g, cfg0, "cpu", std=0.3),
              "connector": live.init_connector(g, cfg, "cpu")}
    feats = np.random.RandomState(2).randn(6, cfg.frame_num_tokens,
                                           16).astype(np.float32)
    ms = MultiStreamEngine(params, tok, cfg, num_streams=2, kv_capacity=512,
                           page_size=16, chunk_frames=2, device="cpu")
    for i in range(2):
        ms.input_frames(i, 0.0, feats)
        ms.input_query(i, "what now?", 1.0)
    while ms.pending():
        ms.step()
    assert all(len(t) >= 1 for t in ms.transcripts)
    ent = next(iter(ms._prefix_entries.values()))
    assert ent["tail_page"] is not None
    free0 = ms.stats()["pool"]["pages_free"]
    ms.close_stream(0)
    assert ms.stats()["pool"]["pages_free"] > free0
    ms.input_frames(0, 0.0, feats[:2])
    while ms.pending():
        ms.step()
    pool = ms.stats()["pool"]
    assert pool["prefix_hits"] == 1 and pool["prefix_entries"] == 1
    # the readmitted stream's pages: the template's full pages aliased, a
    # private copy of its tail page holding the template's rows up to the
    # prompt's length
    tab = ms._table_host[0]
    full, r = divmod(ent["length"], ms.page_size)
    assert list(tab[:full]) == ent["pages"]
    lat = ms.cache.latent
    assert torch.equal(lat[:, int(tab[full]), :r],
                       lat[:, ent["tail_page"], :r])
    c = ms.counters()
    assert c["moe_layer_calls"] > 0 and c["moe_pairs"] >= 2 * c[
        "moe_peak_pairs"] > 0


def _tiny_ds_config():
    c = _tiny.config("deepseek-v2-lite-bf16")
    c.update(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
             num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
             n_routed_experts=8, num_experts_per_tok=2, head_dim=16)
    return c


def test_engine_serves_two_streams_against_reference():
    """The benchmark's serving driver on the DeepSeek-V2 family at a tiny
    size: MultiStreamEngine over the latent pool serves two streams through
    a closed backlog (each video's end closes its stream, the next one is
    admitted from the prefix cache with a copied tail page), and the
    served tokens and gate margins are judged against the fp32 reference
    over the rebuilt dialogues: fp32 both sides, so the served tokens are
    the reference's best (mean gap under 1e-4) and the gates agree to
    1e-3."""
    seen = {}

    def patch(eng):
        seen["eng"] = eng
        copies = [0]
        orig = eng._copy_page_multi

        def counted(src, dsts):
            copies[0] += len(dsts)
            return orig(src, dsts)
        eng._copy_page_multi = counted
        seen["copies"] = copies

    b = _tiny.bench("tiny.ds", "deepseek-v2-lite-bf16", "narrate64",
                    "deepseek-v2-lite-bf16.narrate64")
    out = run.run_cell("tiny.ds", SEED, 1.5, False, device="cpu", bench=b,
                       config=_tiny_ds_config(),
                       mix=_tiny.serve_mix(streams=2), patch=patch,
                       t0=time.perf_counter())
    assert out["correct"] and out["failed"] == 0
    ck = out["checks"]
    assert ck["served_tokens"]["value"] > 0 and ck["judged_gates"]["value"] > 0
    assert ck["mean_gap"]["value"] < 1e-4
    assert ck["gate_gap"]["value"] < 1e-3
    eng = seen["eng"]
    pool = eng.stats()["pool"]
    assert pool["prefix_hits"] > 0 and seen["copies"][0] > 0
    assert eng.counters()["moe_layer_calls"] > 0
