"""The per-rank bodies of the port's parallel tests (``tests/_torch_dist.py``
runs them in ``gloo`` worlds on the CPU). This module imports torch, numpy
and the port only: the JAX side of each comparison runs in the test
process. Every function takes (rank, world, ...) and returns plain numpy
or Python values."""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _mesh(world, model, device="cpu"):
    from videollm_online_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(data=world // model, model=model, device=device)


def _np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------ collectives
def collectives(rank, world):
    """Each collective's forward and backward on rank-distinct inputs:
    x = rank + arange; the backward's cotangent is (rank + 1) * ones."""
    from videollm_online_tpu_torch.parallel import collectives as coll
    from videollm_online_tpu_torch.parallel.mesh import MODEL_AXIS
    mesh = _mesh(world, world)
    out = {}
    for name, fn in (
            ("all_reduce", lambda x: coll.all_reduce(x, mesh, MODEL_AXIS)),
            ("all_gather", lambda x: coll.all_gather(x, mesh, MODEL_AXIS, 1)),
            ("all_to_all", lambda x: coll.all_to_all(x, mesh, MODEL_AXIS,
                                                     0, 1)),
            ("ring_shift", lambda x: coll.ring_shift(x, mesh, MODEL_AXIS))):
        x = (rank * 100 + torch.arange(world * 6, dtype=torch.float32)
             ).reshape(world * 2, 3).requires_grad_(True)
        y = fn(x)
        (g,) = torch.autograd.grad(y, x, torch.full_like(y, rank + 1.0))
        out[name] = (_np(y), _np(g))
    coll.reset_stats()
    coll.all_reduce(torch.ones(5), mesh, MODEL_AXIS)
    out["stats"] = (dict(coll.STATS["calls"]), dict(coll.STATS["bytes"]))
    out["objects"] = coll.all_gather_object({"rank": rank})
    return out


# ------------------------------------------------- sequence-parallel attn
def sp_attention(rank, world, cases):
    """cases: (impl, causal, q, k, v, cot) with global numpy arrays
    (B, H, T, d); returns this rank's (out, dq, dk, dv) blocks of T, or
    the refusal's message."""
    from videollm_online_tpu_torch.ops.ring_attention import (
        ring_attention, shard_sequence)
    from videollm_online_tpu_torch.ops.ulysses_attention import (
        ulysses_attention)
    from videollm_online_tpu_torch.parallel.mesh import MODEL_AXIS
    mesh = _mesh(world, world)
    fns = {"ring": ring_attention, "ulysses": ulysses_attention}
    results = []
    for impl, causal, q, k, v, cot in cases:
        qkv = [shard_sequence(torch.from_numpy(a), mesh, MODEL_AXIS)
               .clone().requires_grad_(True) for a in (q, k, v)]
        try:
            out = fns[impl](*qkv, mesh=mesh, axis_name=MODEL_AXIS,
                            causal=causal)
        except AssertionError as e:
            results.append(("refused", str(e)))
            continue
        grads = torch.autograd.grad(
            out, qkv, shard_sequence(torch.from_numpy(cot), mesh,
                                     MODEL_AXIS))
        results.append(("ok", [_np(out)] + [_np(g) for g in grads]))
    return results


# ----------------------------------------------------------- TP serving
def _serving_setup(jparams, model, policy="tp", dtype=None):
    from videollm_online_tpu_torch.core.config import tiny_live_config
    from videollm_online_tpu_torch.models.bridge import params_from_numpy
    from videollm_online_tpu_torch.tokenizer.live_tokenizer import (
        LiveTokenizer)
    from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer
    from videollm_online_tpu_torch.train import step
    tok = LiveTokenizer(ByteTokenizer(), tiny_live_config())
    cfg = tok.cfg.replace(frame_token_interval_threshold=0.725,
                          max_response_tokens=12)
    params = params_from_numpy(jparams, device="cpu", dtype=dtype)
    return tok, cfg, params


def _drive_engine(eng, feats):
    eng.load_video(feats)
    eng.input_query_stream("what now?", video_time=1.0)
    out = []
    for i in range(feats.shape[0]):
        eng.input_video_stream(i / eng.frame_fps)
        while True:
            q, r = eng()
            if r is None:
                break
            out.append((q, r))
    return out


def tp_engine(rank, world, model, jparams, feats, quant):
    """The JAX package's TP serving scenario (tests/test_sharding.py) on
    ``LiveInferEngine`` with params cut ``tp`` over model=``model``:
    {(quant, spec decode): (transcript, kv heads in the ring, the
    unsharded engine's transcript)} for each of ``quant``."""
    from videollm_online_tpu_torch.models.quant import quantize_live_params
    from videollm_online_tpu_torch.parallel.mesh import maybe_mesh
    from videollm_online_tpu_torch.serve.engine import LiveInferEngine
    from videollm_online_tpu_torch.train import step
    tok, cfg, base = _serving_setup(jparams, model)
    mesh = _mesh(world, model)
    out = {}
    for bits, spec in quant:
        params = base if bits is None else quantize_live_params(base, bits)
        kw = dict(kv_capacity=1024, device="cpu", spec_decode=spec)
        single = (None if bits is None and not spec else _drive_engine(
            LiveInferEngine(params, tok, cfg, **kw), feats))
        sharded = step.shard_params(params, mesh, policy="tp", cfg=cfg)
        with maybe_mesh(mesh):
            eng = LiveInferEngine(sharded, tok, cfg, **kw)
            got = _drive_engine(eng, feats)
        out[(bits, spec)] = (got, int(eng.cache.k.shape[2]), single)
    return out


def tp_multistream(rank, world, model, jparams, feats):
    """The JAX package's TP multistream scenario on the blocking tick and
    on the pipelined one (depth 2, as the JAX test runs it): {(paged,
    pipelined): (transcripts, kv heads in the cache, the dispatch counts
    but the host's wait)}."""
    from videollm_online_tpu_torch.parallel.mesh import maybe_mesh
    from videollm_online_tpu_torch.serve.multistream import MultiStreamEngine
    from videollm_online_tpu_torch.train import step
    tok, cfg, params = _serving_setup(jparams, model)
    mesh = _mesh(world, model)
    sharded = step.shard_params(params, mesh, policy="tp", cfg=cfg)
    out = {}
    for paged in (True, False):
        for pipelined in (False, True):
            with maybe_mesh(mesh):
                ms = MultiStreamEngine(sharded, tok, cfg,
                                       num_streams=len(feats),
                                       kv_capacity=1024, chunk_frames=4,
                                       paged=paged, device="cpu",
                                       pipelined=pipelined, pipeline_depth=2)
                for i in range(len(feats)):
                    ms.input_frames(i, 0.0, feats[i])
                ms.input_query(0, "what now?", video_time=1.2)
                for _ in range(64):
                    ms.step()
                    if not ms.pending():
                        break
                if pipelined:
                    ms.flush()
            counts = ms.dispatch_stats()
            counts.pop("wait_s")      # a time, not a decision
            out[paged, pipelined] = (ms.transcripts,
                                     int(ms.cache.k.shape[2]), counts)
    return out


def tp_first_logits(rank, world, model):
    """The first forward of a small decoder in the mixed int4 serving
    layout (q4c MLP and head, int8 attention; d 256 and F 512, so the
    int4 scale groups of 128 stay whole on each of up to 4 ranks), on a
    fresh ring and on a 4-stream paged pool, under TP over
    model=``model`` against the unsharded forward: {cache: (relative norm
    error of the logits, kv heads in the cache)}."""
    from videollm_online_tpu_torch.core.config import LlamaConfig
    from videollm_online_tpu_torch.models import llama
    from videollm_online_tpu_torch.models.quant import quantize_llama_params
    from videollm_online_tpu_torch.ops.auto import auto_attention
    from videollm_online_tpu_torch.parallel.mesh import maybe_mesh
    from videollm_online_tpu_torch.train.step import shard_params
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                      dtype="float32")
    params = quantize_llama_params(
        llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu"),
        bits=4)
    streams, page = 4, 16

    def forward(p, paged):
        if paged:
            cache = llama.init_paged_kv_cache(
                cfg, streams, pool_pages=1 + 2 * streams, pages_per_stream=2,
                page_size=page, device="cpu")
            cache.table[:] = 1 + torch.arange(2 * streams,
                                              dtype=torch.int32).view(-1, 2)
            ids = 33 + torch.arange(20)[None] + 5 * torch.arange(streams)[:,
                                                                       None]
        else:
            cache = llama.init_kv_cache(cfg, 1, 64, device="cpu")
            ids = (33 + torch.arange(20))[None]
        logits, _ = llama.forward(p, cfg=cfg, input_ids=ids, kv_cache=cache,
                                  attn_impl=auto_attention)
        return logits, int(cache.k.shape[2])

    mesh = _mesh(world, model)
    local = shard_params(params, mesh, "tp", cfg=cfg)
    out = {}
    for paged in (False, True):
        want, _ = forward(params, paged)
        with maybe_mesh(mesh):
            got, kv_heads = forward(local, paged)
        out["paged" if paged else "ring"] = (
            float((got - want).norm() / want.norm()), kv_heads)
    return out


# ------------------------------------------------------------- training
def sharded_step(rank, world, model, jparams, batch, cfg_kw, policy,
                 step_kw=None, sp=None):
    """tests/test_sharding.py's computation on the port: the loss of the
    sharded forward, then one optimizer step's loss and grad norm, and
    two steps' trainable leaves (the first step's lr is 0). ``sp``
    ("ring" or "ulysses"): the step's attention is sequence parallel over
    the model axis, and the weights are cut over data only, as the trainer
    cuts them."""
    from videollm_online_tpu_torch.core.config import (
        LiveConfig, LlamaConfig, LoraConfig, tiny_vision_config)
    from videollm_online_tpu_torch.models import live
    from videollm_online_tpu_torch.models.bridge import params_from_numpy
    from videollm_online_tpu_torch.parallel.mesh import maybe_mesh
    from videollm_online_tpu_torch.tokenizer.live_tokenizer import (
        LiveTokenizer)
    from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer
    from videollm_online_tpu_torch.train import optim, step
    cfg = LiveConfig(llama=LlamaConfig(**cfg_kw["llama"]),
                     vision=tiny_vision_config(),
                     lora=LoraConfig(**cfg_kw["lora"]),
                     vision_hidden_size=32, max_num_frames=64)
    cfg = LiveTokenizer(ByteTokenizer(), cfg).cfg
    mesh = _mesh(world, model)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    local = step.shard_params(params_from_numpy(jparams, device="cpu"),
                              mesh, policy, cfg=cfg,
                              axes=("data",) if sp else ("data", "model"))
    sb = step.shard_batch(tb, mesh, cfg=cfg)
    oc = optim.OptimConfig(total_steps=10, learning_rate=1e-3)
    step_kw = dict(step_kw or {})
    if sp is not None:
        from videollm_online_tpu_torch.ops.ring_attention import (
            make_ring_attn)
        from videollm_online_tpu_torch.ops.ulysses_attention import (
            make_ulysses_attn)
        make = make_ring_attn if sp == "ring" else make_ulysses_attn
        step_kw["attn_impl"] = make(mesh, "model")
    with maybe_mesh(mesh):
        with torch.no_grad():
            _, loss = live.forward(local, cfg, input_ids=sb["input_ids"],
                                   labels=sb["labels"],
                                   frames=sb.get("frames"),
                                   shard=sb.get("shard"),
                                   attn_impl=step_kw.get("attn_impl"))
        state, frozen = step.init_train_state(local)
        metrics = []
        for _ in range(2):
            state, m = step.train_step(state, frozen, sb, cfg=cfg,
                                       optim_cfg=oc,
                                       schedule=optim.make_schedule(oc),
                                       **step_kw)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    leaves = {"/".join(k): _np(v) for k, v in _flat(state.trainable)}
    return float(loss), metrics, leaves


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _logged(out, key="loss"):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [r[key] for r in map(json.loads, f) if key in r]


def entry_runs(rank, world, coin_root, out_root, common, runs, max_new):
    """``train_entry.train`` or ``evaluate_entry.evaluate`` with each run's
    extra arguments (the COIN root and the generate evaluators' token
    budget patched as the single-process tests patch them); rank 0 returns
    the logged losses and the written eval metrics, every rank its mesh
    and attention's sequence axis."""
    from videollm_online_tpu_torch import evaluate_entry, train_entry
    from videollm_online_tpu_torch.data.coin import base as coin
    from videollm_online_tpu_torch.data.coin import benchmarks
    coin.COIN.root = coin_root
    benchmarks.COINBenchmark.evaluation_kwargs = dict(
        benchmarks.COINBenchmark.evaluation_kwargs, max_new_tokens=max_new)
    result = {}
    for name, entry, extra in runs:
        out = os.path.join(out_root, name)
        argv = ["--device", "cpu", *common, "--output_dir", out, *extra]
        info = {}
        if entry == "train":
            trainer = train_entry.train(argv)
            info = {"mesh": repr(trainer.mesh),
                    "attn": getattr(trainer.attn_impl, "sequence_axis",
                                    None)}
        else:
            info["metrics"] = evaluate_entry.evaluate(argv)
        if rank == 0:
            if entry == "train":
                info["losses"] = _logged(out)
            path = os.path.join(out, "eval_results.json")
            if os.path.exists(path):
                with open(path) as f:
                    info["eval"] = json.load(f)
        result[name] = info
    return result


def many(rank, world, calls):
    """Several of this module's bodies in one world: ``calls`` is a list
    of (function name, extra arguments); returns their results in order."""
    return [globals()[name](rank, world, *args) for name, args in calls]


def tp_forward_cuda(rank, world):
    """A TP forward of a small bf16 decoder (d 128, so K1 takes the ring)
    on this rank of a world sharing the card, against the unsharded
    forward on the same weights: (relative norm error of the logits, K1
    launches under the mesh, whether the mesh copies through the host)."""
    from videollm_online_tpu_torch.core.config import LlamaConfig
    from videollm_online_tpu_torch.models import llama
    from videollm_online_tpu_torch.ops import decode_attention as da
    from videollm_online_tpu_torch.ops.auto import auto_attention
    from videollm_online_tpu_torch.parallel.mesh import maybe_mesh
    from videollm_online_tpu_torch.train.step import shard_params
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=1024,
                      num_layers=2, num_heads=8, num_kv_heads=2,
                      head_dim=128, dtype="bfloat16")
    params = llama.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    ids = (33 + torch.arange(12))[None]

    def forward(p):
        cache = llama.init_kv_cache(cfg, 1, 256, device="cuda")
        logits, _ = llama.forward(p, cfg=cfg, input_ids=ids, kv_cache=cache,
                                  attn_impl=auto_attention)
        return logits.float()

    want = forward(params)
    mesh = _mesh(world, world, "cuda")
    sharded = shard_params(params, mesh, "tp", cfg=cfg)
    before = da.ring_decode_attention_layered.launches
    with maybe_mesh(mesh):
        got = forward(sharded)
    torch.cuda.synchronize()
    return {"rel": float((got - want).norm() / want.norm()),
            "k1": da.ring_decode_attention_layered.launches - before,
            "staging": mesh.host_staging}
