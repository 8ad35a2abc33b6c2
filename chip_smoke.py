#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (videollm_online_tpu_torch) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases, in order;
any failure raises and exits non-zero:

  1. the card's name and power limit, and the torch / CUDA / nvcc / Triton
     versions;
  2. build every kernel under videollm_online_tpu_torch/csrc (one nvcc per
     source, all started together);
  3. K1 (ring decode attention) against its plain PyTorch version at the 8B
     shapes (bf16, window, int8 K/V, fp32), with its time at S = 1, 20 and
     64 beside the plain version's, scaled_dot_product_attention's (a
     yardstick the port never calls) and the bandwidth bound;
  4. a small fp32 engine twice, once through K1 and once through the plain
     attention: the transcripts must be equal;
  5. the main path: the 8B int8 LiveInferEngine with random weights built
     on the card, 64 frames of random features, spec decode on.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM
BF16_FLOPS_PER_S = 989e12      # H100 SXM, dense
BF16_TOL = 2e-2                # atol = rtol, bf16 in and out
FP32_TOL = 1e-5                # atol = rtol, fp32 in and out


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time per call of fn(i) issued eagerly from Python, by CUDA
    events: the host's launch cost is inside it when it exceeds the
    device's work."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int, reps: int = 20) -> float:
    """Device time per call of fn(i), i < calls: the calls are captured
    once in a CUDA graph and the graph is replayed, so no host launch cost
    is inside the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(calls):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * calls)


# ---------------------------------------------------------------- phase 1
def phase_toolchain():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    from videollm_online_tpu_torch.ops import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch.version.cuda {torch.version.cuda}, nvcc: {nvcc[-1]}, "
        f"triton {triton_version}")
    log(f"device: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    return smi


# ---------------------------------------------------------------- phase 2
def phase_build():
    from videollm_online_tpu_torch.ops import _build
    names = _build.all_sources()
    t0 = time.perf_counter()
    seconds = _build.build(names)
    log(f"build: {names} in {time.perf_counter() - t0:.2f} s "
        f"(per source {seconds})")
    for name in names:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
        _build.load(name)


# ---------------------------------------------------------------- phase 3
def _k1_case(k_all, v_all, layer, offset, S, *, window=None, ks=None,
             vs=None, dtype=torch.bfloat16, gen=None):
    from videollm_online_tpu_torch.ops import decode_attention as da
    B, Hq, d = 1, 32, k_all.shape[-1]
    q = torch.randn((B, Hq, S, d), generator=gen, device="cuda").to(dtype)
    q_pos = (offset + torch.arange(S, device="cuda", dtype=torch.int32))[None]
    got = da.ring_decode_attention_layered(q, k_all, v_all, q_pos, layer,
                                           window=window, k_scale=ks,
                                           v_scale=vs)
    want = da.ring_decode_attention_layered_reference(
        q, k_all, v_all, q_pos, layer, window=window, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    err = (got.float() - want.float()).abs()
    ok = bool((err <= tol + tol * want.float().abs()).all())
    max_err = float(err.max())
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(
            f"K1 disagrees: layer {layer} offset {offset} S {S} window "
            f"{window} int8 {ks is not None} {dtype}: max abs err {max_err}")
    return max_err


def _k1_timing(k_all, v_all, offset, S, gen):
    """Kernel, plain version and SDPA over the visible keys, each call on
    the next layer so the K/V are read cold from HBM as in a forward."""
    from videollm_online_tpu_torch.ops import decode_attention as da
    L, B, Hkv, C, d = k_all.shape
    Hq = 32
    q = torch.randn((B, Hq, S, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    q_pos = (offset + torch.arange(S, device="cuda", dtype=torch.int32))[None]
    n = offset + S                     # visible slots: [0, offset + S)
    mask = (torch.arange(n, device="cuda")[None, :]
            <= q_pos[0][:, None])      # (S, n)
    k_vis = [k_all[l][:, :, :n] for l in range(L)]
    v_vis = [v_all[l][:, :, :n] for l in range(L)]

    def kern(i):
        return da.ring_decode_attention_layered(q, k_all, v_all, q_pos, i % L)

    def plain(i):
        return da.ring_decode_attention_layered_reference(
            q, k_all, v_all, q_pos, i % L)

    def lib(i):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k_vis[i % L], v_vis[i % L], attn_mask=mask, enable_gqa=True)

    times = {"ms": graph_ms(kern, L), "plain_ms": graph_ms(plain, L),
             "library_ms": graph_ms(lib, L),
             "eager_ms": cuda_ms(kern, iters=10 * L)}
    elt = 2
    bytes_ = (2 * B * Hq * S * d * elt + 2 * B * Hkv * n * d * elt
              + B * S * 4)
    flops = 4 * B * Hq * d * int(sum(offset + s + 1 for s in range(S)))
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    return {**times, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_k1():
    from videollm_online_tpu_torch.ops import decode_attention as da
    gen = torch.Generator(device="cuda").manual_seed(0)
    L, B, Hkv, C, d = 32, 1, 8, 16384, 128
    shape = (L, B, Hkv, C, d)
    k_all = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    v_all = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    errs = {"bf16": 0.0, "window": 0.0, "int8": 0.0, "fp32": 0.0}
    n_cases = 0
    for layer in (0, 31):
        for offset in (1, 511, 512, 3000, 15000):
            for S in (1, 14, 20, 64):
                errs["bf16"] = max(errs["bf16"], _k1_case(
                    k_all, v_all, layer, offset, S, gen=gen))
                n_cases += 1
    for offset, S in ((3000, 1), (15000, 1), (15000, 20), (15000, 64)):
        errs["window"] = max(errs["window"], _k1_case(
            k_all, v_all, 31, offset, S, window=4096, gen=gen))
        n_cases += 1
    timing = {S: _k1_timing(k_all, v_all, 3000, S, gen)
              for S in (1, 20, 64)}
    k8 = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                       dtype=torch.int8)
    v8 = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                       dtype=torch.int8)
    ks = torch.rand(shape[:-1], generator=gen, device="cuda") / 64
    vs = torch.rand(shape[:-1], generator=gen, device="cuda") / 64
    for offset, S in ((3000, 1), (3000, 20), (15000, 14)):
        errs["int8"] = max(errs["int8"], _k1_case(
            k8, v8, 31, offset, S, ks=ks, vs=vs, gen=gen))
        n_cases += 1
    del k8, v8, ks, vs
    k32, v32 = k_all.float(), v_all.float()
    del k_all, v_all
    errs["fp32"] = _k1_case(k32, v32, 31, 3000, 20, dtype=torch.float32,
                            gen=gen)
    n_cases += 1
    del k32, v32
    torch.cuda.empty_cache()
    log(f"K1 vs plain: {n_cases} cases agree; max abs err {errs} "
        f"(tolerance atol = rtol = {BF16_TOL} bf16, {FP32_TOL} fp32)")
    for S, t in timing.items():
        log(f"K1 at 8B shapes, offset 3000, S={S}, bf16, device time per "
            f"call from CUDA-graph replay over the 32 layers: kernel "
            f"{t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, sdpa "
            f"{t['library_ms']:.5f} ms, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}, {HBM_BYTES_PER_S / 1e12} TB/s); eager "
            f"kernel call from Python {t['eager_ms']:.5f} ms")
    assert da.ring_decode_attention_layered.launches > 0
    return {"max_abs_err": max(errs.values()), **timing[1]}


# ---------------------------------------------------------------- phase 4
def _drive(engine, feats, query_every, feed_every, fps):
    engine.reset()
    engine.load_video(feats)
    out = []
    for i in range(len(feats)):
        if i % query_every == 0:
            engine.input_query_stream(
                "Please narrate the video in real time.", video_time=i / fps)
        if i % feed_every == feed_every - 1 or i == len(feats) - 1:
            engine.input_video_stream(i / fps)
        while True:
            q, r = engine()
            if r is None:
                break
            out.append((q, r))
    return out


def phase_small_engine():
    from videollm_online_tpu_torch.core.config import (LiveConfig,
                                                       LlamaConfig)
    from videollm_online_tpu_torch.models import live, llama
    from videollm_online_tpu_torch.ops.decode_attention import (
        ring_decode_attention_layered as k1)
    from videollm_online_tpu_torch.serve.engine import LiveInferEngine
    from videollm_online_tpu_torch.tokenizer.live_tokenizer import (
        LiveTokenizer)
    from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer
    lcfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                       num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
                       dtype="float32")
    cfg = LiveConfig(llama=lcfg, lora=None, vision_hidden_size=64)
    tok = LiveTokenizer(ByteTokenizer(), cfg)
    cfg = tok.cfg.replace(max_response_tokens=20)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = {"llama": llama.init_params(gen, cfg.llama, device="cuda"),
              "connector": live.init_connector(gen, cfg, device="cuda")}
    feats = np.random.RandomState(0).randn(
        24, cfg.frame_num_tokens, cfg.vision_hidden_size).astype(np.float32)
    kw = dict(kv_capacity=4096, spec_decode=True, device="cuda")
    k1.launches = 0
    with_k1 = _drive(LiveInferEngine(params, tok, cfg, **kw), feats, 8, 8,
                     cfg.frame_fps)
    n_k1 = k1.launches
    plain = _drive(LiveInferEngine(params, tok, cfg, attn_impl=llama._attention,
                                   **kw), feats, 8, 8, cfg.frame_fps)
    if with_k1 != plain:
        raise AssertionError(f"transcripts differ:\n{with_k1}\n{plain}")
    if n_k1 == 0 or not with_k1:
        raise AssertionError(f"K1 launches {n_k1}, responses {len(with_k1)}")
    log(f"small fp32 engine (hd 64, G 4): {len(with_k1)} responses, equal "
        f"transcripts through K1 ({n_k1} launches) and plain attention")


# ---------------------------------------------------------------- phase 5
# kernel classes by name: K1, cuBLAS matmuls, and the dtype-casting copies
# (chiefly quantized_matmul's per-call int8 -> bf16 weight conversion)
KERNEL_CLASSES = (("K1", ("k1_",)),
                  ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
                  ("cast copies", ("copy_kernel",)))


def _profile_forward(params, cfg, cache, attn_impl, S):
    """One S-token forward on the engine's ring, timed without the profiler
    and then under torch.profiler: device time by kernel class, and the
    share of the profiled forward's wall time in which the card ran no
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    from videollm_online_tpu_torch.models import llama

    emb = llama.embed_tokens(params["llama"],
                             torch.full((1, S), 33, dtype=torch.int32),
                             cfg.llama)

    def fwd():
        return llama.forward(params["llama"], cfg=cfg.llama,
                             inputs_embeds=emb, kv_cache=cache,
                             attn_impl=attn_impl,
                             logit_gather_positions=torch.arange(S)[None])

    fwd()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd()
    torch.cuda.synchronize()
    plain_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if "CUDA" in str(e.device_type) and e.self_device_time_total]
    total = sum(t for _, t, _ in kernels)
    shares = {name: 0.0 for name, _ in KERNEL_CLASSES}
    shares["other"] = 0.0
    for key, t, _ in kernels:
        cls = next((name for name, marks in KERNEL_CLASSES
                    if any(m in key.lower() for m in marks)), "other")
        shares[cls] += t
    if not total:
        log(f"profile of one {S}-token forward: the profiler saw no device "
            f"time (not measured)")
        return
    log(f"profile of one {S}-token forward (8B int8, offset "
        f"{int(cache.offset[0])}): wall {plain_us:.1f} us without the "
        f"profiler, {wall_us:.1f} us with it, device busy "
        f"{total:.1f} us ({100 * total / wall_us:.1f}% of wall), by class "
        + ", ".join(f"{k} {v:.1f} us" for k, v in shares.items()))
    for key, t, n in sorted(kernels, key=lambda k: -k[1])[:6]:
        log(f"  {t:10.1f} us  x{n:<4d} {key[:90]}")


def phase_main_path(n_frames: int = 64):
    from videollm_online_tpu_torch.core.config import (LiveConfig,
                                                       LlamaConfig)
    from videollm_online_tpu_torch.models import generate as gen_mod
    from videollm_online_tpu_torch.models import live, llama, quant
    from videollm_online_tpu_torch.ops.decode_attention import (
        ring_decode_attention_layered as k1)
    from videollm_online_tpu_torch.serve.engine import LiveInferEngine
    from videollm_online_tpu_torch.tokenizer.live_tokenizer import (
        LiveTokenizer)
    from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer

    lcfg = LlamaConfig(vocab_size=128256, hidden_size=4096,
                       intermediate_size=14336, num_layers=32, num_heads=32,
                       num_kv_heads=8, head_dim=128, dtype="bfloat16")
    cfg = LiveConfig(llama=lcfg, lora=None)
    tok = LiveTokenizer(ByteTokenizer(), cfg)
    query_every, resp_tokens = 8, 20
    cfg = tok.cfg.replace(frame_token_interval_threshold=0.725,
                          max_response_tokens=resp_tokens,
                          gate_logit_bias=30.0)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = {"llama": quant.random_quantized_llama_params(
                  gen, cfg.llama, bits=8, device="cuda"),
              "connector": live.init_connector(gen, cfg, device="cuda")}
    torch.cuda.synchronize()
    log(f"8B int8 params built on the card in "
        f"{time.perf_counter() - t0:.2f} s "
        f"({quant.param_bytes(params) / 2**30:.2f} GiB)")
    capacity = max(8192, (4 + cfg.frame_num_tokens) * (n_frames + 8)
                   + (n_frames // query_every + 2)
                   * (256 + cfg.max_response_tokens) + 2048)
    feats = np.random.RandomState(0).randn(
        n_frames, cfg.frame_num_tokens, cfg.vision_hidden_size
    ).astype(np.float32)
    engine = LiveInferEngine(params, tok, cfg, kv_capacity=capacity,
                             spec_decode=True, device="cuda")
    _drive(engine, feats[:16], query_every, 8, cfg.frame_fps)   # warm-up
    torch.cuda.synchronize()
    k1.launches = 0
    t0 = time.perf_counter()
    transcript = _drive(engine, feats, query_every, 8, cfg.frame_fps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = k1.launches
    steps, emitted = (int(x) for x in engine.spec_stats())
    if not transcript or launches == 0:
        raise AssertionError(f"responses {len(transcript)}, K1 launches "
                             f"{launches}")
    if not all(isinstance(r, str) and "Assistant:" in r
               for _, r in transcript):
        raise AssertionError(f"malformed responses: {transcript[:2]}")
    log(f"main path (8B int8, bf16 KV, capacity {capacity}, spec decode): "
        f"{n_frames} frames in {dt:.3f} s = {n_frames / dt:.3f} frames/s, "
        f"{len(transcript)} responses, final offset {engine._host_offset}, "
        f"K1 launches {launches}, spec {steps} verify steps -> {emitted} "
        f"tokens ({emitted / max(steps, 1):.3f} tokens/step)")
    log(f"first response: {transcript[0]!r}")

    # K1 against its plain version on the main path's own ring (capacity,
    # layout and K/V written by the run), at a decode and a verify step
    cache = engine.cache
    ring_err = max(
        _k1_case(cache.k, cache.v, layer, engine._host_offset - 20, S,
                 gen=gen)
        for layer in (0, lcfg.num_layers - 1) for S in (1, 20))
    log(f"K1 vs plain on the main path's ring (C {cache.capacity}, offset "
        f"{engine._host_offset - 20}): max abs err {ring_err}")

    # decode on the same ring, timed with a host clock around synchronised
    # work: a greedy response (one token per forward) and a spec-decode one
    # (K + 1 tokens per verify forward), each from a 3-token prompt forward
    prompt_ids = torch.tensor([[33, 34, 35]])
    prompt = llama.embed_tokens(params["llama"], prompt_ids, cfg.llama)
    for mode in ("greedy", "spec"):
        torch.cuda.synchronize()
        k1.launches = 0
        t0 = time.perf_counter()
        if mode == "greedy":
            _, length, _ = gen_mod.greedy_generate(
                params, cfg, cache, prompt, [3], max_new_tokens=32,
                attn_impl=engine.attn_impl)
            forwards = int(length[0])
        else:
            _, length, _, _, _, st = gen_mod.ngram_speculative_generate(
                params, cfg, cache, prompt, [3],
                torch.zeros((gen_mod.SPEC_HIST,), dtype=torch.int32),
                torch.tensor(0, dtype=torch.int32), prompt_ids=prompt_ids[0],
                max_new_tokens=32, draft_len=engine.spec_draft,
                attn_impl=engine.attn_impl)
            forwards = int(st[0])
        torch.cuda.synchronize()
        n_tok = int(length[0])
        log(f"{mode} decode (8B int8, offset {int(cache.offset[0])}): "
            f"{n_tok} tokens in {forwards} forwards, "
            f"{(time.perf_counter() - t0) * 1e3 / n_tok:.3f} ms/token, K1 "
            f"launches per forward {k1.launches / forwards:.2f} (each one "
            f"split kernel + one merge kernel)")
    logits, _ = llama.forward(params["llama"], cfg=cfg.llama,
                              inputs_embeds=prompt[:, :1], kv_cache=cache,
                              attn_impl=engine.attn_impl)
    if logits.shape != (1, 1, cfg.llama.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    for S in (1, engine.spec_draft + 1):
        _profile_forward(params, cfg, cache, engine.attn_impl, S)
    return {"launches": launches, "ring_err": ring_err}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import videollm_online_tpu_torch  # noqa: F401  (fails outside the repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = phase_toolchain()
    phase_build()
    k1 = phase_k1()
    phase_small_engine()
    main_path = phase_main_path()
    log(f"card: {smi}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "ring_decode_attention_layered",
        "route": "cuda",
        "source": "videollm_online_tpu_torch/csrc/decode_attention.cu",
        "replaces": "videollm_online_tpu/ops/decode_attention.py:249",
        "launches": main_path["launches"],
        "max_abs_err": max(k1["max_abs_err"], main_path["ring_err"]),
        **{key: k1[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
