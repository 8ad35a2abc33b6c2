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
  5. the serving main path: the 8B int8 LiveInferEngine with random
     weights built on the card, 64 frames of random features, spec decode
     on;
  6. K2 (flash attention forward, dK/dV and dQ) against its plain PyTorch
     versions at the 8B training shapes (B 1, Hq 32, Hkv 8, T = S = 4096,
     d 128, bf16) and on small cases (fp32, G = 1, window, q_offset,
     kv_valid, ragged T, d 64 and 256), each output held elementwise and by
     its relative norm error (K2_TOL), with each kernel's time beside its
     plain version's, scaled_dot_product_attention's and the bound;
  7. a small fp32 trainer twice, once through K2 and once through the plain
     attention: the per-step losses and grad norms must agree;
  8. the training main path: LiveTrainer over the 8B int8 base with LoRA
     r 128 on the seven projections and lm_head (dropout 0.05) and the
     connector, one synthetic live1+ sample of T = 4096, remat on: per-step
     loss, grad norm, ms/step and tokens/s, peak memory, K2 launches per
     step (64 / 32 / 32), a profile of one step, and one 2-layer step at
     the same widths through K2 against the plain attention (each also read
     against the step in fp32, per gradient leaf).

The launch counts are set to 0 just before each main path and read just
after it. The line before the last is the kernels' JSON summary; the last
line is
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


# ---------------------------------------------------------------- phase 6
# K2 against its plain version, per tensor: elementwise |got - ref| <= atol
# + rtol |ref|, and the relative norm |got - ref| / |ref| <= rel. In bf16
# the atol sits far below a typical value (|out| and |dq| in a middle row of
# the 8B case are about 0.025) so that an error on small elements shows;
# rtol carries the large ones, whose bf16 rounding differs by an ulp. The
# bounds sit above the readings over this phase's cases: bf16 needs an atol
# up to 1.5e-3 at rtol 2e-2 and reads a relative norm error up to 2.3e-3;
# fp32 (dK/dV sum up to G * T products in another order) up to 2.8e-6 and
# 8.8e-7.
K2_TOL = {torch.bfloat16: {"atol": 2e-3, "rtol": 2e-2, "rel": 5e-3},
          torch.float32: {"atol": 1e-5, "rtol": 1e-4, "rel": 1e-5}}
# the fp32 lse, either input dtype
K2_LSE_TOL = {"atol": 1e-4, "rtol": 1e-4, "rel": 1e-5}
FP32_FLOPS_PER_S = 67e12   # H100 SXM, fp32 outside the tensor cores


def _k2_inputs(B, Hq, Hkv, T, S, d, dtype, gen):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return rnd(B, Hq, T, d), rnd(B, Hkv, S, d), rnd(B, Hkv, S, d), \
        rnd(B, Hq, T, d)


def _close(name, got, want, tol):
    """Holds got to want at tol ({"atol", "rtol", "rel"}); returns the
    readings: max abs error, the least atol that passes at tol's rtol, the
    relative norm error and the median |want|."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    r = {"max": float(err.max()),
         "atol": max(float((err - tol["rtol"] * w.abs()).max()), 0.0),
         "rel": float((g - w).norm() / w.norm().clamp(min=1e-30)),
         "median": float(w.abs().median())}
    if (r["atol"] > tol["atol"] or r["rel"] > tol["rel"]
            or not bool(torch.isfinite(got).all())):
        raise AssertionError(f"{name}: {r} over tolerance {tol}")
    return r


def _readings(r):
    return (f"max {r['max']:.3g}, atol needed {r['atol']:.3g}, rel "
            f"{r['rel']:.3g}, median |ref| {r['median']:.3g}")


def _k2_case(label, B, Hq, Hkv, T, S, d, dtype, gen, *, q_offset=0,
             window=None, kv_valid=None):
    """K2's three kernels against their plain versions on one input. The
    backward kernels and their plain version take the plain forward's out
    and lse, so each kernel is held against the same function of the same
    inputs."""
    from videollm_online_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _k2_inputs(B, Hq, Hkv, T, S, d, dtype, gen)
    scale = 1.0 / d ** 0.5
    kw = dict(causal=True, q_offset=q_offset, window=window,
              kv_valid=kv_valid)
    out, lse = fa.flash_fwd(q, k, v, scale, **kw)
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, scale, **kw)
    delta = fa.softmax_delta(do, ref_out)
    dk, dv = fa.flash_dkdv(q, k, v, do, ref_lse, delta, scale, **kw)
    dq = fa.flash_dq(q, k, v, do, ref_lse, delta, scale, **kw)
    ref_dq, ref_dk, ref_dv = fa.flash_bwd_plain(q, k, v, do, ref_lse,
                                                delta, scale, **kw)
    torch.cuda.synchronize()
    tol = K2_TOL[dtype]
    r = {name: _close(f"{kern} {label} {name}", got, want,
                      K2_LSE_TOL if name == "lse" else tol)
         for kern, name, got, want in (
             ("K2f", "out", out, ref_out), ("K2f", "lse", lse, ref_lse),
             ("K2b", "dk", dk, ref_dk), ("K2b", "dv", dv, ref_dv),
             ("K2q", "dq", dq, ref_dq))}
    log(f"K2 vs plain, {label} (tolerance {tol}, lse {K2_LSE_TOL}):")
    for name, reading in r.items():
        log(f"  {name}: {_readings(reading)}")
    errs = {"fwd": max(r["out"]["max"], r["lse"]["max"]),
            "dkdv": max(r["dk"]["max"], r["dv"]["max"]),
            "dq": r["dq"]["max"]}
    return errs, (q, k, v, do, ref_out, ref_lse, delta, scale, kw)


def _k2_timing(q, k, v, do, out, lse, delta, scale, kw):
    """Device time per call (CUDA events over 10 calls) of each K2
    kernel, its plain version and scaled_dot_product_attention (a yardstick
    the port never calls: its forward for K2f, its backward, fwd+bwd minus
    fwd, for K2b and K2q), with each kernel's bound from this input's
    visible (row, col) pairs."""
    from videollm_online_tpu_torch.ops import flash_attention as fa
    B, Hq, T, d = q.shape
    S = k.shape[2]
    F = torch.nn.functional

    def sdpa_fwd(_):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              scale=scale, enable_gqa=True)

    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def sdpa_fwd_bwd(_):
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                           scale=scale, enable_gqa=True)
        o.backward(do)

    iters, warmup = 10, 2
    t = {
        "fwd": cuda_ms(lambda _: fa.flash_fwd(q, k, v, scale, **kw), iters,
                       warmup),
        "dkdv": cuda_ms(lambda _: fa.flash_dkdv(q, k, v, do, lse, delta,
                                                scale, **kw), iters, warmup),
        "dq": cuda_ms(lambda _: fa.flash_dq(q, k, v, do, lse, delta, scale,
                                            **kw), iters, warmup),
        "plain_fwd": cuda_ms(lambda _: fa.flash_attention_fwd_reference(
            q, k, v, scale, **kw), iters, warmup),
        "plain_bwd": cuda_ms(lambda _: fa.flash_bwd_plain(
            q, k, v, do, lse, delta, scale, **kw), iters, warmup),
        "sdpa_fwd": cuda_ms(sdpa_fwd, iters, warmup),
    }
    t["sdpa_bwd"] = cuda_ms(sdpa_fwd_bwd, iters, warmup) - t["sdpa_fwd"]
    mask = fa.visible_mask(T, S, kw["q_offset"], True, kw["window"],
                    S if kw["kv_valid"] is None else kw["kv_valid"], "cuda")
    pairs = int(mask.sum()) * B * Hq
    elt = q.element_size()
    q_bytes, kv_bytes, row_bytes = q.numel() * elt, k.numel() * elt, B * Hq * T * 4
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    work = {"fwd": (4 * d * pairs, 2 * q_bytes + 2 * kv_bytes + row_bytes),
            "dkdv": (8 * d * pairs, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
            "dq": (6 * d * pairs, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes)}
    res = {}
    for name, (flops, bytes_) in work.items():
        t_ops = flops / peak * 1e3
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        res[name] = {"ms": t[name],
                     "plain_ms": t["plain_fwd" if name == "fwd" else "plain_bwd"],
                     "library_ms": t["sdpa_fwd" if name == "fwd" else "sdpa_bwd"],
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "gflop": flops / 1e9}
    return res


def phase_k2():
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, fp32 = torch.bfloat16, torch.float32
    errs, main_inputs = _k2_case("8B training shapes B1 Hq32 Hkv8 T=S=4096 "
                                 "d128 bf16", 1, 32, 8, 4096, 4096, 128, bf16,
                                 gen)
    for label, shape, kw in (
            ("fp32 Hq8 Hkv2 T=S=512 d128", (1, 8, 2, 512, 512, 128, fp32), {}),
            ("G=1 Hq8 Hkv8 T=S=1024 d128 bf16",
             (1, 8, 8, 1024, 1024, 128, bf16), {}),
            ("window 1024 Hq8 Hkv2 T=S=4096 d128 bf16",
             (1, 8, 2, 4096, 4096, 128, bf16), {"window": 1024}),
            ("q_offset 1024, T 512 against S 1536, d128 bf16",
             (1, 8, 2, 512, 1536, 128, bf16), {"q_offset": 1024}),
            ("kv_valid 900 of S 1024, d128 bf16",
             (2, 8, 2, 1024, 1024, 128, bf16), {"kv_valid": 900}),
            ("T=S=1000 (not a multiple of the tile) d128 bf16",
             (1, 8, 2, 1000, 1000, 128, bf16), {}),
            ("T=S=333 d64 fp32", (1, 4, 2, 333, 333, 64, fp32), {}),
            ("T=S=300 d256 bf16", (1, 4, 1, 300, 300, 256, bf16), {})):
        case_errs, _ = _k2_case(label, *shape, gen, **kw)
        errs = {n: max(errs[n], case_errs[n]) for n in errs}
    timing = _k2_timing(*main_inputs)
    for name, t in timing.items():
        log(f"K2 {name} at the 8B training shapes (B1 Hq32 Hkv8 T=S=4096 "
            f"d128 bf16, causal, {t['gflop']:.1f} GFLOP), device ms per "
            f"call: kernel {t['ms']:.3f}, plain {t['plain_ms']:.3f}, sdpa "
            f"{t['library_ms']:.3f}, bound {t['bound_ms']:.4f} "
            f"({t['bound_by']})")
    del main_inputs
    torch.cuda.empty_cache()
    return {name: {**timing[name], "max_abs_err": errs[name]}
            for name in timing}


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


def _all_launch_counters():
    from videollm_online_tpu_torch.ops import decode_attention as da
    from videollm_online_tpu_torch.ops import flash_attention as fa
    return {"K1": da.ring_decode_attention_layered, "K2f": fa.flash_fwd,
            "K2b": fa.flash_dkdv, "K2q": fa.flash_dq}


def _zero_launches():
    for fn in _all_launch_counters().values():
        fn.launches = 0


def _read_launches():
    return {name: fn.launches for name, fn in _all_launch_counters().items()}


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
    _zero_launches()
    t0 = time.perf_counter()
    transcript = _drive(engine, feats, query_every, 8, cfg.frame_fps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _read_launches()
    launches = counts["K1"]
    log(f"serving main path launches: {counts}")
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


# ---------------------------------------------------------------- phase 7
TRAIN_FP32_TOL = 1e-4    # rtol, per-step loss and grad norm, fp32
# The 2-layer bf16 step through K2 against the same step through the plain
# attention: the relative loss error, and per gradient leaf (each layer of a
# stacked LoRA leaf on its own) the relative norm error K2 vs plain as a
# share of the leaf's own bf16 error (plain vs fp32). Both bounds are set
# from the readings at seed 3: loss 3.6e-5, shares 0.33 to 0.39.
TRAIN_BF16_LOSS_TOL = 1e-4
TRAIN_BF16_LEAF_SHARE = 0.5


def synthetic_batch(cfg, seq: int, rng: np.random.RandomState):
    """A live1+-shaped training sample laid out as the JAX package's
    benchmarks/train_bench.py lays it out: a 64-token text prefix, then
    [interval, <v> x frame_num_tokens] groups, supervision on the interval
    slots and the text span."""
    fnt = cfg.frame_num_tokens
    text_len = 64
    n_frames = (seq - text_len) // (fnt + 1)
    ids = np.zeros((1, seq), np.int32)
    labels = np.full((1, seq), -100, np.int32)
    ids[0, :text_len] = rng.randint(4, min(cfg.llama.vocab_size, 30000),
                                    (text_len,))
    labels[0, 8:text_len] = ids[0, 8:text_len]
    pos = text_len
    for _ in range(n_frames):
        ids[0, pos] = cfg.frame_token_interval_id
        labels[0, pos] = cfg.frame_token_interval_id
        ids[0, pos + 1:pos + 1 + fnt] = cfg.v_placeholder_id
        pos += fnt + 1
    frames = rng.randn(n_frames, fnt, cfg.vision_hidden_size).astype(
        np.float32)
    return {"input_ids": ids, "labels": labels, "frames": frames}, n_frames


def _trainer(params, cfg, tok, out_dir, batch, steps, attn_impl):
    """The port's LiveTrainer over a dataset of one pre-collated sample."""
    from videollm_online_tpu_torch.core.arguments import parse_args
    from videollm_online_tpu_torch.train.trainer import LiveTrainer
    args = parse_args(["--max_steps", str(steps), "--logging_steps", "1",
                       "--gradient_accumulation_steps", "1",
                       "--dataloader_num_workers", "0",
                       "--output_dir", out_dir])
    return LiveTrainer(params=params, cfg=cfg, tokenizer=tok, args=args,
                       train_dataset=[batch] * (steps + 1),
                       collate_fn=lambda items: items[0], attn_impl=attn_impl)


def _out_dir(name: str) -> str:
    """An empty directory for a trainer's logs, under the git-ignored
    build/ of the checkout."""
    import pathlib
    import shutil
    path = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke" / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return str(path)


def _logged(out_dir):
    import os
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_small_trainer():
    """A small fp32 trainer (hd 64, G 4, T 256 so K2 dispatches), run once
    through K2 and once through the plain attention: equal per-step losses
    and grad norms. LoRA dropout stays on: its masks depend only on
    (step, layer, projection), so both runs draw the same ones."""
    from videollm_online_tpu_torch.core.config import (LiveConfig,
                                                       LlamaConfig,
                                                       LoraConfig)
    from videollm_online_tpu_torch.models import live, llama
    from videollm_online_tpu_torch.ops.auto import auto_attention
    from videollm_online_tpu_torch.tokenizer.live_tokenizer import (
        LiveTokenizer)
    from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer
    lcfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                       num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
                       dtype="float32")
    cfg = LiveConfig(llama=lcfg, lora=LoraConfig(r=8, alpha=16),
                     vision_hidden_size=64)
    tok = LiveTokenizer(ByteTokenizer(), cfg)
    cfg = tok.cfg
    batch, _ = synthetic_batch(cfg, 256, np.random.RandomState(0))
    runs = {}
    for name, impl in (("K2", auto_attention), ("plain", llama._attention)):
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = live.init_params(gen, cfg, device="cuda")
        out_dir = _out_dir(f"small_{name}")
        _zero_launches()
        _trainer(params, cfg, tok, out_dir, batch, 4, impl).train()
        runs[name] = (_logged(out_dir), _read_launches())
    (got, n), (want, n_plain) = runs["K2"], runs["plain"]
    for g, w in zip(got, want):
        for key in ("loss", "grad_norm"):
            if abs(g[key] - w[key]) > TRAIN_FP32_TOL * abs(w[key]):
                raise AssertionError(f"small trainer step {g['step']} {key}: "
                                     f"K2 {g[key]} vs plain {w[key]}")
    if len(got) != 4 or min(n["K2f"], n["K2b"], n["K2q"]) == 0 or any(
            n_plain.values()):
        raise AssertionError(f"steps {len(got)}, launches {n} / {n_plain}")
    log(f"small fp32 trainer (hd 64, G 4, T 256, 4 steps): losses "
        f"{[round(r['loss'], 6) for r in got]} and grad norms equal through "
        f"K2 ({n}) and plain attention (rtol {TRAIN_FP32_TOL})")


# ---------------------------------------------------------------- phase 8
TRAIN_KERNEL_CLASSES = (("K2f", ("k2_fwd",)), ("K2b", ("k2_dkdv",)),
                        ("K2q", ("k2_dq",)),
                        ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
                        ("cast copies", ("copy_kernel",)))


def _profile_step(trainer, tbatch):
    """One more train step under torch.profiler: device time by kernel
    class and the share of the step's wall time the card was busy."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.state, m = trainer._step(trainer.state, trainer.frozen,
                                         tbatch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if "CUDA" in str(e.device_type) and e.self_device_time_total]
    total = sum(t for _, t, _ in kernels)
    if not total:
        log("profile of one train step: the profiler saw no device time "
            "(not measured)")
        return
    shares = {name: 0.0 for name, _ in TRAIN_KERNEL_CLASSES}
    shares["other"] = 0.0
    other = []
    for key, t, n in kernels:
        cls = next((name for name, marks in TRAIN_KERNEL_CLASSES
                    if any(mk in key.lower() for mk in marks)), "other")
        shares[cls] += t
        if cls == "other":
            other.append((key, t, n))
    log(f"profile of one 8B train step: wall {wall_us / 1e3:.1f} ms under "
        f"the profiler, device busy {total / 1e3:.1f} ms "
        f"({100 * total / wall_us:.1f}% of wall), by class "
        + ", ".join(f"{k} {v / 1e3:.1f} ms" for k, v in shares.items()))

    def short(key):
        for prefix in ("void ", "at::native::", "(anonymous namespace)::"):
            key = key.replace(prefix, "")
        return key[:150]

    for key, t, n in sorted(kernels, key=lambda k: -k[1])[:8]:
        log(f"  {t / 1e3:10.2f} ms  x{n:<5d} {short(key)}")
    log("  'other', its 12 largest kernels:")
    for key, t, n in sorted(other, key=lambda k: -k[1])[:12]:
        log(f"  {t / 1e3:10.2f} ms  x{n:<5d} {short(key)}")


def _lora_8b_params(cfg, gen, num_layers=None):
    from videollm_online_tpu_torch.models import live, llama, quant
    lcfg = cfg.llama
    if num_layers is not None:
        import dataclasses
        lcfg = dataclasses.replace(lcfg, num_layers=num_layers)
    return {"llama": quant.random_quantized_llama_params(gen, lcfg, bits=8,
                                                         device="cuda"),
            "connector": live.init_connector(gen, cfg, device="cuda"),
            "lora": llama.init_lora_params(gen, lcfg, cfg.lora,
                                           device="cuda")}


def _named_grads(trainable, grads):
    """(name, fp32 gradient) per leaf, in tree_leaves order; a stacked
    LoRA leaf (L, ...) gives one entry per layer."""
    out = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}.{k}" if path else k)
            return
        g = next(it).float()
        if path.startswith("lora.layers."):
            out.extend((f"{path}[{i}]", g[i]) for i in range(g.shape[0]))
        else:
            out.append((path, g))

    it = iter(grads)
    walk(trainable, "")
    return out


def _two_layer_parity(cfg, batch):
    """At the 8B widths and a depth of 2 layers, one step's loss and
    LoRA/connector gradients in bf16 through K2, held against the same
    bf16 step through the plain attention: TRAIN_BF16_LOSS_TOL on the
    loss, and on each leaf its relative norm error may be at most
    TRAIN_BF16_LEAF_SHARE of the plain bf16 step's error against the step
    in fp32 (the same int8 codes, fp32 everything else, plain attention).
    Every leaf's readings are printed by name, with the median and the
    worst leaf of each comparison."""
    import dataclasses

    from videollm_online_tpu_torch.models import llama
    from videollm_online_tpu_torch.ops.auto import auto_attention
    from videollm_online_tpu_torch.train import optim
    from videollm_online_tpu_torch.train import step as step_mod
    cfg2 = cfg.replace(llama=dataclasses.replace(cfg.llama, num_layers=2))
    params = _lora_8b_params(cfg2, torch.Generator(device="cuda").manual_seed(3))
    # a non-zero LoRA B, so every adapter gets a gradient
    gen = torch.Generator(device="cuda").manual_seed(4)
    for pair in list(params["lora"]["layers"].values()) + [
            params["lora"]["lm_head"]]:
        pair["lora_b"].normal_(0.0, 0.02, generator=gen)
    tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    cfg32 = cfg2.replace(llama=dataclasses.replace(cfg2.llama,
                                                   dtype="float32"))
    params32 = optim.tree_map(
        lambda x: x.float() if x.is_floating_point() else x, params)
    def fp32_attention(q, k, v, *a, **kw):
        return llama._attention(q.float(), k.float(), v.float(), *a,
                                **kw).to(q.dtype)

    out = {}
    for name, p, c, impl in (("K2", params, cfg2, auto_attention),
                             ("plain", params, cfg2, llama._attention),
                             ("fp32 attention", params, cfg2, fp32_attention),
                             ("fp32", params32, cfg32, llama._attention)):
        state, frozen = step_mod.init_train_state(p)
        loss = step_mod.loss_fn(state.trainable, frozen, c, tb,
                                attn_impl=impl, dropout_seed=7)
        grads = torch.autograd.grad(loss, optim.tree_leaves(state.trainable))
        out[name] = (float(loss.detach()),
                     _named_grads(state.trainable, grads))
        del state, loss, grads

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-30))

    loss = {name: l for name, (l, _) in out.items()}
    pairs = (("K2", "plain"), ("K2", "fp32"), ("plain", "fp32"),
             ("fp32 attention", "fp32"), ("fp32 attention", "plain"))
    names = [n for n, _ in out["fp32"][1]]
    grads = {name: [g for _, g in gs] for name, (_, gs) in out.items()}
    leaves = [(n, *(rel(grads[a][i], grads[b][i]) for a, b in pairs),
               float(grads["fp32"][i].norm()))
              for i, n in enumerate(names)]
    log(f"2-layer 8B-width step, loss: " + ", ".join(
        f"{name} {l:.6f}" for name, l in loss.items()) + "; per gradient "
        f"leaf, relative norm error " + " / ".join(
            f"{a} vs {b}" for a, b in pairs) + ", and |grad| in fp32 (the "
        f"bf16 steps differ in their attention only; 'fp32 attention' runs "
        f"the plain attention on fp32 copies of q, k and v):")
    for n, *cols in leaves:
        log(f"  {n:28s} " + " ".join(f"{x:.3e}" for x in cols))
    for col, (a, b) in enumerate(pairs, start=1):
        ranked = sorted(leaves, key=lambda x: x[col])
        mid, worst = ranked[len(ranked) // 2], ranked[-1]
        log(f"  {a} vs {b}: median leaf {mid[col]:.3e} ({mid[0]}), worst "
            f"{worst[col]:.3e} ({worst[0]})")
    loss_err = abs(loss["K2"] - loss["plain"]) / abs(loss["plain"])
    share = {n: kp / max(pf, 1e-30) for n, kp, _, pf, *_ in leaves}
    worst = max(share, key=share.get)
    log(f"  loss K2 vs plain {loss_err:.3e} (tolerance "
        f"{TRAIN_BF16_LOSS_TOL}); K2 vs plain as a share of plain vs fp32: "
        f"median {sorted(share.values())[len(share) // 2]:.3f}, worst "
        f"{share[worst]:.3f} ({worst}; tolerance {TRAIN_BF16_LEAF_SHARE})")
    if loss_err > TRAIN_BF16_LOSS_TOL or share[worst] > TRAIN_BF16_LEAF_SHARE:
        raise AssertionError(f"2-layer 8B-width bf16 step through K2 "
                             f"differs from the plain attention's: loss "
                             f"{loss_err}, {worst} {share[worst]}")


def phase_main_training(steps: int = 4, seq: int = 4096):
    """The training main path: the 8B int8 base (random, built on the
    card), LoRA r 128 / alpha 256 on the seven projections and lm_head
    with dropout 0.05, the connector from 1024-d features, one synthetic
    live1+ sample of T = 4096, through LiveTrainer with remat on."""
    from videollm_online_tpu_torch.core.config import (LiveConfig,
                                                       LlamaConfig,
                                                       LoraConfig)
    from videollm_online_tpu_torch.ops.auto import auto_attention
    from videollm_online_tpu_torch.tokenizer.live_tokenizer import (
        LiveTokenizer)
    from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer
    from videollm_online_tpu_torch.train import optim
    lcfg = LlamaConfig(vocab_size=128256, hidden_size=4096,
                       intermediate_size=14336, num_layers=32, num_heads=32,
                       num_kv_heads=8, head_dim=128, dtype="bfloat16")
    cfg = LiveConfig(llama=lcfg, lora=LoraConfig(r=128, alpha=256,
                                                 dropout=0.05),
                     vision_hidden_size=1024)
    tok = LiveTokenizer(ByteTokenizer(), cfg)
    cfg = tok.cfg
    batch, n_frames = synthetic_batch(cfg, seq, np.random.RandomState(0))
    t0 = time.perf_counter()
    params = _lora_8b_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    out_dir = _out_dir("main_8b")
    trainer = _trainer(params, cfg, tok, out_dir, batch, steps,
                       auto_attention)
    del params
    n_train = optim.count_params(trainer.state.trainable)
    log(f"8B int8 base + LoRA r 128 built on the card in "
        f"{time.perf_counter() - t0:.2f} s: {n_train / 1e6:.1f} M trainable "
        f"parameters; sample T {seq}, {n_frames} frames")

    def watched(tr):
        return {"connector fc2.w": tr["connector"]["fc2"]["w"],
                "lora wq.lora_b": tr["lora"]["layers"]["wq"]["lora_b"]}

    before = {k: v.detach().clone()
              for k, v in watched(trainer.state.trainable).items()}

    # steps 1-2, then check the trainables moved (step 0 takes lr 0)
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    trainer.total_steps = 2
    trainer.train()
    changed = {k: not torch.equal(before[k], v.detach())
               for k, v in watched(trainer.state.trainable).items()}
    trainer.total_steps = steps
    trainer.train()
    torch.cuda.synchronize()
    counts = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    logs = _logged(out_dir)
    for r in logs:
        ms = 1e3 / r["steps_per_sec"]
        log(f"8B train step {r['step']}: loss {r['loss']:.5f}, grad_norm "
            f"{r['grad_norm']:.5f}, {ms:.1f} ms/step, "
            f"{seq / ms * 1e3:.1f} tokens/s")
    log(f"8B training: peak memory {peak / 2**30:.2f} GiB "
        f"(max_memory_allocated), launches over {steps} steps {counts}")
    per_step = {k: counts[k] / steps for k in ("K2f", "K2b", "K2q")}
    want = {"K2f": 2 * lcfg.num_layers, "K2b": lcfg.num_layers,
            "K2q": lcfg.num_layers}
    if per_step != want:
        raise AssertionError(f"K2 launches per step {per_step}, want {want}")
    if len(logs) != steps or not all(np.isfinite(r["loss"]) for r in logs):
        raise AssertionError(f"bad losses {logs}")
    if not all(changed.values()):
        raise AssertionError(f"trainables unchanged after step 2: {changed}")
    log(f"K2 launches per step {per_step} (as expected); trainables changed "
        f"by step 2 {changed}")
    tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    _profile_step(trainer, tb)
    step_ms = [1e3 / r["steps_per_sec"] for r in logs[1:]]
    del trainer, tb
    torch.cuda.empty_cache()
    _two_layer_parity(cfg, batch)
    return {"launches": counts, "step_ms": step_ms, "peak": peak}


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
    k2 = phase_k2()
    phase_small_trainer()
    training = phase_main_training()
    log(f"card: {smi}; total {time.perf_counter() - t_start:.1f} s")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    k2_source = "videollm_online_tpu_torch/csrc/flash_attention.cu"
    kernels = [{
        "name": "ring_decode_attention_layered",
        "route": "cuda",
        "source": "videollm_online_tpu_torch/csrc/decode_attention.cu",
        "replaces": "videollm_online_tpu/ops/decode_attention.py:249",
        "launches": main_path["launches"],
        "max_abs_err": max(k1["max_abs_err"], main_path["ring_err"]),
        **{key: k1[key] for key in keys},
    }]
    for name, part, label, replaces in (
            ("flash_fwd", "fwd", "K2f",
             "videollm_online_tpu/ops/flash_attention.py:144"),
            ("flash_dkdv", "dkdv", "K2b",
             "videollm_online_tpu/ops/flash_attention.py:324"),
            ("flash_dq", "dq", "K2q",
             "videollm_online_tpu/ops/flash_attention.py:359")):
        kernels.append({"name": name, "route": "cuda", "source": k2_source,
                        "replaces": replaces,
                        "launches": training["launches"][label],
                        "max_abs_err": k2[part]["max_abs_err"],
                        **{key: k2[part][key] for key in keys}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
