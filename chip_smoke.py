#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (videollm_online_tpu_torch) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases, in order;
any failure raises and exits non-zero:

  1. the card's name and power limit, and the torch / CUDA / nvcc / Triton
     versions;
  2. build every kernel under videollm_online_tpu_torch/csrc (one nvcc per
     source, all started together), and for each kernel of
     flash_attention.cu, decode_attention.cu, paged_attention.cu and
     fused_mlp.cu print its registers and spill bytes from nvcc's -Xptxas
     -v log, its HGMMA (wgmma) and HMMA (mma.sync) instructions in the
     library's SASS (cuobjdump; "not measured" without one) and ptxas's
     wgmma notes, failing if a wgmma kernel (K2's three, K4's), the
     streaming core of K5, K6 and K7 or a tensor-core decode kernel spills,
     has no such instruction or has its wgmma serialized;
  3. K1 (ring decode attention) against its plain PyTorch version at the 8B
     shapes (bf16, window, int8 K/V, fp32; S 1 / 7 / 14 / 20 / 21 / 64, so
     rows that are not a multiple of 16, window edges inside a tile) and
     at d 64 over two ragged streams, every case run with the wrapper's
     split count and with one split, each twice with equal bits; with its
     time at S = 1, 20 and 64 beside the plain version's,
     scaled_dot_product_attention's (a yardstick the port never calls) and
     the bound;
  4. a small fp32 engine twice, once through K1 and once through the plain
     attention: the transcripts must be equal;
  5. the serving main path: the 8B int8 LiveInferEngine with random
     weights built on the card, 64 frames of random features, spec decode
     on;
  6. K2 (flash attention forward, dK/dV and dQ) against its plain PyTorch
     versions at the 8B training shapes (B 1, Hq 32, Hkv 8, T = S = 4096,
     d 128, bf16) and on small cases (bf16 d 64 and 128, fp32, d 256, G =
     1, B 2, window, q_offset not a multiple of a tile, kv_valid, ragged
     T), each output held elementwise and by its relative norm error
     (K2_TOL), with each kernel's time beside its plain version's,
     scaled_dot_product_attention's and the bound, its TFLOP/s and share
     of the bound, and the pairs the tensor-core kernels compute in whole
     tiles against the visible ones;
  7. a small fp32 trainer twice, once through K2 and once through the plain
     attention: the per-step losses and grad norms must agree;
  8. the training main path: LiveTrainer over the 8B int8 base with LoRA
     r 128 on the seven projections and lm_head (dropout 0.05) and the
     connector, one synthetic live1+ sample of T = 4096, remat on: per-step
     loss, grad norm, ms/step and tokens/s, peak memory, K2 launches per
     step (64 / 32 / 32), a profile of one step, and one 2-layer step at
     the same widths through K2 against the plain attention (each also read
     against the step in fp32, per gradient leaf);
  9. the fused-MLP kernels K4, K5, K6 and K7 against their plain PyTorch
     versions at the 8B shapes (D 4096, F 14336; head K 4096, N 128256) for
     1, 20, 91 and 128 rows (K5 also 8) and on small odd cases (groups
     below 128, column tails, unaligned byte rows, fp32 and bf16 x), the
     same input twice giving equal bits, and each kernel's time beside the
     plain version's, the dequantizing route's and the bound; K5, K6 and
     K7 on both of their routes (the streaming core, the mma.sync family)
     and K5 and K6 beside one library call for the same function
     (tinygemm's _weight_int4pack_mm; _weight_int8pack_mm); then one call
     of K4, K5, K6 and K7 launch by launch on each route: each launch's
     device time and bytes moved;
 10. a small fp32 engine on mixed int4 weights twice, once through K4 and K5
     and once through their plain versions: transcripts equal, or equal up
     to a step that is shown to be a tie flip;
 11. the int4 serving main path: serve/cli.py's ``build_engine`` with
     ``--model_size 8b --quantize int4 --spec_decode`` and a ring of 8192,
     the stream of phase 5: frames/s, ms/token, parameter bytes, launches of
     K1 / K4 / K5 per forward (K4 32, K5 1 up to 128 rows; none above), a
     profile of a 1-token and a 20-token forward by kernel class, then
     ``cli.main`` itself on 8 frames (20-token responses);
 12. K6 and K7, which no serving main path reaches, through 8-layer engines
     at the 8B widths: int8 layers with the MLP routed to K6 (its A/B), and
     row-packed q4p layers, which the dispatch sends to K7 (on the
     streaming core at these shapes);
 13. K3 (paged decode attention) against its plain PyTorch version at the
     8B shapes (8 streams, Hq 32, Hkv 8, d 128, pages of 512, a pool of 41
     pages under a shuffled table with a trash-page entry, ragged q_pos
     crossing pages, S 1 / 7 / 20 / 21 / 91 / 128, bf16 and int8 pools,
     window off and on; what no query may read, past a stream's last
     visible slot or below its window, is overwritten with NaN for the
     kernel calls) and on small odd cases (d 64, 128 and 256, pages of 32,
     64 and 128, fp32, 1 to 3 streams), every case with the wrapper's split
     count and with one split, each twice with equal bits; with its time at
     S = 1, 20, 91 and 128 over bf16 pools and at S = 20 over int8 pools
     beside the plain version's, the gathering route's
     (index_select of the pages, then scaled_dot_product_attention), K1's
     on an equal ring and the bound;
 14. a small fp32 MultiStreamEngine (3 streams, pages of 64) through K3 and
     through its plain version: transcripts equal (or parted at a step
     shown to be a tie flip), equal to three single-stream engines', and
     stats() holding after a close, a prefix-cache admission and a fork;
 15. the multistream main path: the 8B int8-weight MultiStreamEngine with
     benchmarks/serve_bench.py's traffic (8 streams x 64 frames admitted at
     t = 0, a query every 8 frames, 20-token responses, kv_capacity 2560, so
     a paged pool of 41 pages of 512): aggregate frames/s, responses,
     ticks, stats(), K3 32 launches a forward and no K1 asserted, a profile
     of one batched forward of 1, 20, 91 and 128 tokens; then the same traffic with int8 KV and spec
     decode, and on the batched ring (K1 and the plain attention); then a
     close, a re-admission and a fork;
15b. the engines' dispatch-ahead drivers on those paths, each timed in
     turns with the blocking engine on the same stream and held to its
     transcript, every fill run under set_sync_debug_mode("error") (a host
     synchronisation in one raises): phase 5's stream through
     ``speculative=True`` a frame a call and ``pipelined=True`` 8 frames a
     call, then with the gate bias removed (every frame fires, dispatches
     roll back) speculative in bf16 and pipelined in fp32; phase 11's int4
     engine built by serve/cli.py with ``--pipelined`` (K4, K5) and
     ``cli.main --pipelined`` against phase 11's dialogue; phase 15's 8
     paged streams pipelined, cut to 32 frames a stream: frames/s, wall
     and device ms a frame, the most dispatches in flight, rollbacks, the
     host's wait at resolution, K1 / K3 / K4 / K5 launches;
 16. a small fp32 engine with every option of the demo path at once (a
     SigLIP tower on raw uint8 frames, the int8 KV ring compacted to a
     stream_window, 4-token segments through on_delta, spec decode) through
     K1 and through the plain attention: transcripts and segments equal,
     K1's int8 form launched after the first compaction;
 17. the upstream demo's path at full width: a 64-frame 384 px .avi
     written by the port's write_avi, served by serve/cli.py with
     ``--model_size 8b --with_vision --spec_decode``, once with
     ``--quantize int8 --kv_quant int8 --stream_tokens 4`` and once with
     ``--quantize int4`` (random SigLIP-large and 8B weights built on the
     card; the main paths' 20-token responses and gate bias of 30, so each
     engine answers the opening query and stays silent through the video):
     Average Processing FPS, K1 / K4 / K5 launches and on_delta segments
     of that run, the encoder's ms a frame, the wall against the device
     time of one tick, and the tower's bf16 features against the same
     weights in fp32 (DEMO_ENC_REL);
 18. the offline evaluators on a small fp32 model (d 64): StreamEvaluator
     through K2f and through the plain attention (the four metrics equal,
     the per-position NLL within EVAL_NLL_ATOL), beam_generate and
     greedy_from_embeds through K1 and through the plain attention (the
     same ids), then evaluate_entry on a synthetic COIN root at the 1B
     proxy (greedy decode cut to 64 new tokens from 512);
 19. the offline-evaluation main path at full Llama-3-8B width and depth
     (int8 base, bf16 LoRA r 128 and connector, random, built on the
     card): one 10-minute live1+ narration sample (1200 frames, a turn
     every 10, threshold 0.725) through StreamEvaluator, s/video, ms/turn,
     videos/hour, K2f launched once a layer a sample; the rollforward and
     the chunked int8 lm_head timed on their own; K2f at the eval T held
     against its plain version query chunk by query chunk and timed beside
     it, SDPA and the bound; one LTA beam search (5 beams at B 5, 64 new
     tokens, cut from 512) through K1;
 20. narration refinement on a small fp32 model (d 128):
     make_llama_generate_fn's texts are its greedy ids through K1, equal to
     the same prompts' ids through the plain attention;
 21. the dataset-preparation main path at full width: encode_job over two
     synthetic 384 px .avi videos of 300 frames (a full batch of 256 and a
     padded one each) with random SigLIP-large in bf16: the job's frames/s,
     the device's ms a batch (CUDA events) beside its FLOP bound, the busy
     share, peak memory, the .npy files read back through the feature
     store and the padded batch's rows against the same frames alone; then
     narration refinement (64 new tokens) and LiveChat synthesis (96 new
     tokens, cut from 512) on the 8B int8 decoder (random, built on the
     card) through make_llama_generate_fn: s a narration, ms/token, K1
     launches;
 22. the serving apps at full width: serve/web.py's demo over the 8B int8
     LiveInferEngine as serve/cli.py builds it, driven over HTTP on
     127.0.0.1 (/load, /query, /step; 24 frames, a query every 8): the
     transcript byte-equal to the engine driven directly, /step latency
     p50 / p99; serve_multi over an 8-stream MultiStreamEngine (K3) with
     two sessions, each transcript byte-equal to a fresh engine driven
     through the same polls; StreamingPipeline over the single engine with
     the caller on a non-default CUDA stream, its events equal to a
     sequential drive of the same interleaving;
 23. tensor-parallel serving on two ranks of the card (gloo): phases 5, 11
     and 15's engines on params cut ``tp``, and phase 15's 8 paged streams
     again through the pipelined tick, each rank's transcripts equal to one
     rank's pipelined run;
 24. sharded training on two ranks: phase 8's step under sp_ulysses,
     sp_ring and fsdp_tp;
 25. training's memory-fit mechanisms at T 12288 on phase 8's
     configuration (after phase 8 in the default run): per-layer remat and
     the whole int8 head; --remat_group 2 --mlp_chunk 3072 with the
     column-tiled head; --offload_optimizer --remat_group 2; ms/step,
     tokens/s, peak and held memory, K2 launches a step, the offload's
     bytes a step, losses against the first run's; K2's three kernels at
     T 12288 against their plain versions and timed.

``--phases a,b`` runs the named phases alone and prints no summary;
``--phases train_seeds`` (in no default run) prints the 2-layer step's loss
through K2, the plain attention and the plain attention in fp32 at several
seeds, the spread that phase 8's loss bound must hold;
``--phases tc_configs`` (in no default run either) holds and times each
configuration of K1's and K3's tensor-core kernel at the main paths' chunk
lengths, the A/B behind the wrapper's choice; ``--phases wo_probe`` (in no
default run) builds the streaming core of K5, K6 and K7 with per-warp
clock64 counters and prints its cycles a slot by phase, three cut-down
consumers, the SASS of one slot's loop and the A/B against K4's wgmma
kernel. The
launch counts are set to 0 just before each main path and read just after
it; each phase's time is printed after it. The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM
BF16_FLOPS_PER_S = 989e12      # H100 SXM, dense
# K1 against its plain version, per output: elementwise |got - ref| <= atol
# + rtol |ref| and the relative norm |got - ref| / |ref| <= rel (see _close).
# In bf16 the atol sits well below a typical output (the median |ref| at
# long offsets is about 0.01) and rtol carries the large values, whose bf16
# rounding differs by an ulp. The bounds sit above the readings over phase
# 3's 48 cases: bf16 needs an atol up to 1.2e-3 at rtol 2e-2 and reads a
# relative norm error up to 3.1e-3 (bf16 K/V, window and int8 K/V alike);
# fp32 needs 1.1e-7 and reads 1.0e-6.
K1_TOL = {torch.bfloat16: {"atol": 2e-3, "rtol": 2e-2, "rel": 5e-3},
          torch.float32: {"atol": 1e-6, "rtol": 1e-5, "rel": 5e-6}}


# Single-rank results of the main paths (phases 5, 8, 11 and 18 of a
# default run keep theirs here) that phases 23 and 24 hold their ranks'
# runs against; a phase run alone computes the ones it needs.
_SINGLE_RANK = {}


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
def _kernel_label(mangled: str) -> str:
    """k2_fwd_wgmma_kernel<128> from its mangled name (the FMA kernels'
    element type as f32 or bf16)."""
    import re
    m = re.search(r"(k2_[a-z_]+kernel)I(.*)", mangled)
    if m is None:
        return mangled[:60]
    args = ["f32" if m.group(2).startswith("f") else "bf16"] \
        if re.match(r"(f|13__nv_bfloat16)Li", m.group(2)) else []
    args += re.findall(r"Li(\d+)E", m.group(2))[:1]
    return f"{m.group(1)}<{', '.join(args)}>"


def _cuobjdump():
    import shutil
    from pathlib import Path
    found = shutil.which("cuobjdump")
    if found:
        return found
    candidates = [Path("/usr/local/cuda/bin/cuobjdump")]
    try:
        import triton
        candidates.append(Path(triton.__file__).parent / "backends" / "nvidia"
                          / "bin" / "cuobjdump")
    except ImportError:
        pass
    return next((str(p) for p in candidates if p.exists()), None)


def _ptxas_report(source):
    """Per kernel of csrc/<source>.cu, by mangled name: registers and spill
    bytes from nvcc's -Xptxas -v log; and ptxas's notes on wgmma
    (serialized, fences injected) as (mangled name, note)."""
    from videollm_online_tpu_torch.ops import _build
    return _ptxas_report_log(_build.build_log(source))


def _ptxas_report_log(text):
    """_ptxas_report of one build log's text."""
    import re
    report, name, notes = {}, None, []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        w = re.search(r"\((C75\d\d)\) ([^']*)'(\S+)'", line)
        if w:
            notes.append((w.group(3), f"{w.group(1)} {w.group(2).strip()}"))
        elif m:
            name = m.group(1)
            report[name] = {}
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            report[name]["spill bytes"] = int(st) + int(ld)
        elif name and "Used" in line and "registers" in line:
            report[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return report, notes


_SASS = {}


def _sass(source):
    """cuobjdump -sass of csrc/<source>.cu's library, dumped once, or None
    without cuobjdump."""
    from videollm_online_tpu_torch.ops import _build
    if source not in _SASS:
        tool = _cuobjdump()
        _SASS[source] = tool and subprocess.run(
            [tool, "-sass", str(_build.library_path(source))],
            capture_output=True, text=True, check=True).stdout
    return _SASS[source]


def _sass_count(source, op):
    """Per kernel (mangled name), the SASS instructions of csrc/<source>.cu
    whose line holds ``op`` (cuobjdump -sass), or None without
    cuobjdump."""
    import re
    sass = _sass(source)
    if not sass:
        return None
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and op in line:
            counts[fn] += 1
    return counts


def _demangled(names):
    """Short readable labels of mangled kernel names (cu++filt, else the
    mangled name cut)."""
    import shutil
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    try:
        out = subprocess.run([tool], input="\n".join(names),
                             capture_output=True, text=True,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return {n: n[:80] for n in names}
    labels = {}
    for n, d in zip(names, out):
        for cut in ("(anonymous namespace)::", "<unnamed>::", "(int)"):
            d = d.replace(cut, "")
        d = d.split("(")[0].replace("void ", "").replace("__nv_bfloat16", "bf16")
        labels[n] = d.replace("signed char", "int8").replace("float", "f32")
    return labels


def _k2_kernel_report():
    """Per kernel of flash_attention.cu: registers and spill bytes, and the
    HGMMA instructions in the library's SASS ("not measured" without
    cuobjdump); fails if a wgmma kernel spills, has no HGMMA or has its
    wgmma serialized."""
    raw, notes = _ptxas_report("flash_attention")
    hgmma = _sass_count("flash_attention", "HGMMA")
    report = {}
    for mangled, r in raw.items():
        r["HGMMA"] = ("not measured" if hgmma is None
                      else hgmma.get(mangled, 0))
        report[_kernel_label(mangled)] = r
        log(f"  flash_attention.cu {_kernel_label(mangled)}: {r}")
    if not notes:
        log("  ptxas: no wgmma notes for flash_attention.cu (none serialized)")
    for mangled, note in notes:
        log(f"  ptxas note, {_kernel_label(mangled)}: {note}")
        if "wgmma" in mangled and "serializ" in note.lower():
            raise AssertionError(f"wgmma serialized in {_kernel_label(mangled)}")
    for name in ("k2_fwd_wgmma_kernel<64>", "k2_fwd_wgmma_kernel<128>",
                 "k2_dkdv_wgmma_kernel<64>", "k2_dkdv_wgmma_kernel<128>",
                 "k2_dq_wgmma_kernel<64>", "k2_dq_wgmma_kernel<128>"):
        r = report[name]
        if r["spill bytes"] or (hgmma is not None and not r["HGMMA"]):
            raise AssertionError(f"{name}: {r} (want HGMMA and no spills)")


def _tc_kernel_report(source, mark, ops):
    """Per kernel of csrc/<source>.cu: registers, spill bytes and the
    tensor-core instructions ``ops`` (HGMMA for wgmma, HMMA for mma.sync)
    in the library's SASS ("not measured" without cuobjdump), and ptxas's
    wgmma notes; fails if a kernel whose mangled name matches the regular
    expression ``mark`` (the tensor-core kernels checked) spills, has none
    of ``ops``, or has its wgmma serialized."""
    import re
    raw, notes = _ptxas_report(source)
    counts = {op: _sass_count(source, op) for op in ops}
    labels = _demangled(sorted(raw))
    for mangled in sorted(raw, key=labels.get):
        r = raw[mangled]
        for op, c in counts.items():
            r[op] = "not measured" if c is None else c.get(mangled, 0)
        log(f"  {source}.cu {labels[mangled]}: {r}")
        measured = all(c is not None for c in counts.values())
        if re.search(mark, mangled) and (
                r["spill bytes"] or (measured and not sum(r[op] for op in ops))):
            raise AssertionError(f"{labels[mangled]}: {r} (want {ops} and no "
                                 f"spills)")
    note_labels = _demangled(sorted({n for n, _ in notes}))
    if not notes:
        log(f"  ptxas: no wgmma notes for {source}.cu (none serialized)")
    for mangled, note in notes:
        log(f"  ptxas note, {source}.cu {note_labels[mangled]}: {note}")
    serialized = [note_labels[n] for n, note in notes
                  if re.search(mark, n) and "serializ" in note.lower()]
    if serialized:
        raise AssertionError(f"wgmma serialized in {serialized}")


def phase_build():
    from videollm_online_tpu_torch.ops import _build
    names = _build.all_sources()
    t0 = time.perf_counter()
    seconds = _build.build(names)
    log(f"build: {names} in {time.perf_counter() - t0:.2f} s "
        f"(per source {seconds})")
    # the SASS of every library, dumped side by side for the reports
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_sass, names))
    for name in names:
        if name == "flash_attention":
            _k2_kernel_report()
        elif name in ("decode_attention", "paged_attention"):
            _tc_kernel_report(name, "decode_tc_kernel", ("HGMMA", "HMMA"))
        elif name == "fused_mlp":
            # K4's wgmma instances (N 8 to 128) and the streaming core of K5,
            # K6 and K7 (mma.sync, every layout and N)
            _tc_kernel_report(name, r"fused_mlp_q4c_kernelILi(8|16|32|64|128)E"
                              r"|wo_kernel", ("HGMMA", "HMMA"))
        else:
            for line in _build.build_log(name).splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")
        _build.load(name)


# ---------------------------------------------------------------- phase 3
def _k1_case(k_all, v_all, layer, offset, S, *, window=None, ks=None,
             vs=None, dtype=torch.bfloat16, gen=None, Hq=32):
    from videollm_online_tpu_torch.ops import decode_attention as da
    B, d = k_all.shape[1], k_all.shape[-1]
    q = torch.randn((B, Hq, S, d), generator=gen, device="cuda").to(dtype)
    # stream b's queries at offset + 37 b ...: ragged streams when B > 1
    q_pos = (offset + torch.arange(S, device="cuda", dtype=torch.int32)[None]
             + 37 * torch.arange(B, device="cuda", dtype=torch.int32)[:, None])
    want = da.ring_decode_attention_layered_reference(
        q, k_all, v_all, q_pos, layer, window=window, k_scale=ks, v_scale=vs)
    return _repeatable(
        f"K1 layer {layer} offset {offset} S {S} window {window} int8 "
        f"{ks is not None} {dtype} d {d} B {B}",
        lambda: da.ring_decode_attention_layered(
            q, k_all, v_all, q_pos, layer, window=window, k_scale=ks,
            v_scale=vs), want, K1_TOL[dtype], da)


def _repeatable(name, kern, want, tol, da):
    """Holds kern() to want at tol with the wrapper's split count and with
    one split (ops/decode_attention.py num_splits; the tensor-core kernel
    then writes its output directly, no merge), each called twice on the
    same input, which must give equal bits; returns the worst readings."""
    readings = []
    num_splits = da.num_splits
    try:
        for one_split in (False, True):
            if one_split:
                da.num_splits = lambda *args: 1
            got = kern()
            again = kern()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: two calls on one input differ "
                                     f"(one split {one_split})")
            readings.append(_close(f"{name} one split {one_split}", got,
                                   want, tol))
    finally:
        da.num_splits = num_splits
    return _worst(readings)


def _schedule(da, design, B, Hkv, rows, slots):
    """The launch's (slices, row blocks, splits), as the wrapper sizes it."""
    slices, _, nblk = da.row_blocks(design, rows)
    return slices, nblk, da.num_splits(design, da._sm_count(
        torch.device("cuda")), B, Hkv, rows, slots)


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
    times["schedule"] = _schedule(da, da.kernel_design(q.dtype, d), B, Hkv,
                                  Hq // Hkv * S, C)
    elt = 2
    bytes_ = (2 * B * Hq * S * d * elt + 2 * B * Hkv * n * d * elt
              + B * S * 4)
    flops = 4 * B * Hq * d * int(sum(offset + s + 1 for s in range(S)))
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    return {**times, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _worst(readings):
    """The largest of each reading over a class of cases (the smallest
    median |ref|)."""
    return {k: (min if k == "median" else max)(r[k] for r in readings)
            for k in readings[0]}


def phase_k1():
    from videollm_online_tpu_torch.ops import decode_attention as da
    gen = torch.Generator(device="cuda").manual_seed(0)
    L, B, Hkv, C, d = 32, 1, 8, 16384, 128
    shape = (L, B, Hkv, C, d)
    k_all = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    v_all = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    cases = {"bf16": [], "window": [], "int8": [], "fp32": []}
    for layer in (0, 31):
        for offset in (1, 511, 512, 3000, 15000):
            for S in (1, 7, 14, 20, 21, 64):
                cases["bf16"].append(_k1_case(k_all, v_all, layer, offset, S,
                                              gen=gen))
    for offset, S in ((3000, 1), (15000, 1), (15000, 20), (15000, 64)):
        cases["window"].append(_k1_case(k_all, v_all, 31, offset, S,
                                        window=4096, gen=gen))
    for offset, S in ((3000, 21), (3000, 7)):
        cases["window"].append(_k1_case(k_all, v_all, 0, offset, S,
                                        window=1000, gen=gen))
    timing = {S: _k1_timing(k_all, v_all, 3000, S, gen)
              for S in (1, 20, 64)}
    k8 = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                       dtype=torch.int8)
    v8 = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                       dtype=torch.int8)
    ks = torch.rand(shape[:-1], generator=gen, device="cuda") / 64
    vs = torch.rand(shape[:-1], generator=gen, device="cuda") / 64
    for offset, S, window in ((3000, 1, None), (3000, 20, None),
                              (15000, 14, None), (3000, 21, 1000),
                              (15000, 7, None)):
        cases["int8"].append(_k1_case(k8, v8, 31, offset, S, ks=ks, vs=vs,
                                      window=window, gen=gen))
    del k8, v8, ks, vs
    # d 64, two ragged streams (offsets 700 and 737), bf16 and int8 K/V
    cases["d64"] = []
    shape64 = (2, 2, Hkv, 4096, 64)
    k64, v64 = (torch.randn(shape64, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    k6, v6 = (torch.randint(-127, 128, shape64, generator=gen, device="cuda",
                            dtype=torch.int8) for _ in range(2))
    ks6, vs6 = (torch.rand(shape64[:-1], generator=gen, device="cuda") / 64
                for _ in range(2))
    for S, window in ((1, None), (21, 300), (64, None), (7, 100)):
        cases["d64"].append(_k1_case(k64, v64, 1, 700, S, window=window,
                                     gen=gen))
        cases["d64"].append(_k1_case(k6, v6, 1, 700, S, window=window,
                                     ks=ks6, vs=vs6, gen=gen))
    del k64, v64, k6, v6, ks6, vs6
    k32, v32 = k_all.float(), v_all.float()
    del k_all, v_all
    cases["fp32"].append(_k1_case(k32, v32, 31, 3000, 20,
                                  dtype=torch.float32, gen=gen))
    del k32, v32
    torch.cuda.empty_cache()
    log(f"K1 vs plain: {sum(len(c) for c in cases.values())} cases agree "
        f"(tolerance bf16 {K1_TOL[torch.bfloat16]}, fp32 "
        f"{K1_TOL[torch.float32]}); worst reading per class:")
    for name, readings in cases.items():
        log(f"  {name}: {_readings(_worst(readings))}")
    errs = {name: _worst(readings)["max"] for name, readings in cases.items()}
    for S, t in timing.items():
        log(f"K1 at 8B shapes, offset 3000, S={S}, bf16, device time per "
            f"call from CUDA-graph replay over the 32 layers: kernel "
            f"{t['ms']:.5f} ms ({t['bound_ms'] / t['ms']:.1%} of the "
            f"bound; slices, row blocks, splits {t['schedule']}), "
            f"plain {t['plain_ms']:.5f} ms, sdpa {t['library_ms']:.5f} ms, "
            f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}, "
            f"{HBM_BYTES_PER_S / 1e12} TB/s, {BF16_FLOPS_PER_S / 1e12:.0f} "
            f"TFLOP/s); eager kernel call from Python {t['eager_ms']:.5f} "
            f"ms")
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
                     "gflop": flops / 1e9,
                     "tflops": flops / t[name] / 1e9}
    # whole tiles: the pairs the tensor-core kernels compute, against the
    # visible ones
    if fa.kernel_design(q.dtype, d) == "tensor cores":
        kv_len = S if kw["kv_valid"] is None else kw["kv_valid"]
        for name in ("fwd", "dkdv", "dq"):
            done = fa.computed_pairs(name, T, S, kw["q_offset"], True,
                                     kw["window"], kv_len)
            res[name]["computed_share"] = int(done.sum()) * B * Hq / pairs
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
            ("q_offset 200, T 256 against S 456, d128 bf16",
             (1, 8, 2, 256, 456, 128, bf16), {"q_offset": 200}),
            ("q_offset 256, T 200 against S 456, d128 bf16",
             (1, 8, 2, 200, 456, 128, bf16), {"q_offset": 256}),
            ("kv_valid 900 of S 1024, B 2, d128 bf16",
             (2, 8, 2, 1024, 1024, 128, bf16), {"kv_valid": 900}),
            ("T=S=1000 (not a multiple of the tile) d128 bf16",
             (1, 8, 2, 1000, 1000, 128, bf16), {}),
            ("d64 bf16 B 2 Hq8 Hkv2 T=S=1000", (2, 8, 2, 1000, 1000, 64, bf16),
             {}),
            ("d64 bf16 G=1 Hq4 Hkv4 T=S=512", (1, 4, 4, 512, 512, 64, bf16), {}),
            ("d64 bf16 window 100, kv_valid 300, T=S=384",
             (1, 4, 1, 384, 384, 64, bf16), {"window": 100, "kv_valid": 300}),
            ("d64 bf16 q_offset 200, T 256 against S 456",
             (2, 8, 2, 256, 456, 64, bf16), {"q_offset": 200}),
            ("T=S=333 d64 fp32", (1, 4, 2, 333, 333, 64, fp32), {}),
            ("T=S=300 d256 bf16", (1, 4, 1, 300, 300, 256, bf16), {})):
        case_errs, _ = _k2_case(label, *shape, gen, **kw)
        errs = {n: max(errs[n], case_errs[n]) for n in errs}
    timing = _k2_timing(*main_inputs)
    for name, t in timing.items():
        tiles = (f", whole tiles compute {t['computed_share']:.4f} x the "
                 f"visible pairs" if "computed_share" in t else "")
        log(f"K2 {name} at the 8B training shapes (B1 Hq32 Hkv8 T=S=4096 "
            f"d128 bf16, causal, {t['gflop']:.1f} GFLOP), device ms per "
            f"call: kernel {t['ms']:.4f}, plain {t['plain_ms']:.3f}, sdpa "
            f"{t['library_ms']:.4f}, bound {t['bound_ms']:.4f} "
            f"({t['bound_by']}); kernel {t['tflops']:.1f} TFLOP/s, "
            f"{100 * t['bound_ms'] / t['ms']:.1f}% of the bound{tiles}")
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
# kernel classes by name, the first class that matches (K1's and K3's
# split kernels by their pool type, and the merge of their split partials,
# decode_merge_kernel, on its own; K5 and K6 on the streaming core by its
# layout, 0 q4c and 2 int8): K1, K3, K4, K5, cuBLAS matmuls, and the
# dtype-casting copies (chiefly quantized_matmul's per-call int8 -> bf16
# weight conversion)
KERNEL_CLASSES = (("K1", ("ringpool",)), ("K3", ("pagedpool",)),
                  ("K1/K3 merge", ("decode_merge_kernel",)),
                  ("K4", ("fused_mlp_", "swiglu_merge")),
                  ("K5", ("matmul_int4c_", "wo_kernel<0")),
                  ("K6", ("wo_kernel<2",)),
                  ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
                  ("cast copies", ("copy_kernel",)))


def _profile_forward(params, cfg, cache, attn_impl, S, what="8B int8"):
    """One S-token forward of every stream on the engine's ring or pool,
    timed without the profiler and then under torch.profiler: device time
    by kernel class, and the share of the profiled forward's wall time in
    which the card ran no kernel."""
    from torch.profiler import ProfilerActivity, profile

    from videollm_online_tpu_torch.models import llama

    B = cache.offset.shape[0]
    emb = llama.embed_tokens(params["llama"],
                             torch.full((B, S), 33, dtype=torch.int32),
                             cfg.llama)

    def fwd():
        return llama.forward(
            params["llama"], cfg=cfg.llama, inputs_embeds=emb,
            kv_cache=cache, attn_impl=attn_impl,
            logit_gather_positions=torch.arange(S)[None].expand(B, S))

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
    log(f"profile of one {S}-token forward ({what}, offset "
        f"{int(cache.offset[0])}): wall {plain_us:.1f} us without the "
        f"profiler, {wall_us:.1f} us with it, device busy "
        f"{total:.1f} us ({100 * total / wall_us:.1f}% of wall), by class "
        + ", ".join(f"{k} {v:.1f} us" for k, v in shares.items()))
    for key, t, n in sorted(kernels, key=lambda k: -k[1])[:6]:
        log(f"  {t:10.1f} us  x{n:<4d} {key[:90]}")


def _all_launch_counters():
    from videollm_online_tpu_torch.ops import decode_attention as da
    from videollm_online_tpu_torch.ops import flash_attention as fa
    from videollm_online_tpu_torch.ops import fused_mlp as fm
    from videollm_online_tpu_torch.ops import paged_attention as pa
    return {"K1": da.ring_decode_attention_layered, "K2f": fa.flash_fwd,
            "K2b": fa.flash_dkdv, "K2q": fa.flash_dq,
            "K3": pa.paged_decode_attention,
            "K4": fm.fused_mlp_int4c, "K5": fm.matmul_int4c,
            "K6": fm.fused_mlp_int8, "K7": fm.fused_mlp_int4}


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
    from videollm_online_tpu_torch.ops import decode_attention as da
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
    _SINGLE_RANK["int8"] = transcript

    # K1 against its plain version on the main path's own ring (capacity,
    # layout and K/V written by the run), at a decode and a verify step
    cache = engine.cache
    ring = _worst([
        _k1_case(cache.k, cache.v, layer, engine._host_offset - 20, S,
                 gen=gen)
        for layer in (0, lcfg.num_layers - 1) for S in (1, 20)])
    ring_err = ring["max"]
    log(f"K1 vs plain on the main path's ring (C {cache.capacity}, offset "
        f"{engine._host_offset - 20}): {_readings(ring)}")

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
        S = 1 if mode == "greedy" else engine.spec_draft + 1
        _, _, nsplit = _schedule(da, da.kernel_design(torch.bfloat16, 128),
                                 1, lcfg.num_kv_heads, 4 * S, cache.capacity)
        log(f"{mode} decode (8B int8, offset {int(cache.offset[0])}): "
            f"{n_tok} tokens in {forwards} forwards, "
            f"{(time.perf_counter() - t0) * 1e3 / n_tok:.3f} ms/token, K1 "
            f"launches per forward {k1.launches / forwards:.2f} (at S {S} a "
            f"launch is the split kernel over {nsplit} splits"
            + (" + decode_merge_kernel)" if nsplit > 1 else ")"))
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
# share of the leaf's own bf16 error (plain vs fp32). The shares read 0.33
# to 0.40 at seed 3. The loss bound sits above the spread of two correct
# bf16 attentions: `--phases train_seeds` over seeds 3 to 11 reads K2 vs
# plain up to 1.8e-4 (up to 2.5e-4 with the kernels before Hopper's wgmma
# ones) and the plain attention against itself on fp32 copies of q, k, v
# up to 1.3e-4.
TRAIN_BF16_LOSS_TOL = 5e-4
TRAIN_BF16_LEAF_SHARE = 0.5
TRAIN_SEEDS = (3, 5, 7, 9, 11)


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


def _trainer(params, cfg, tok, out_dir, batch, steps, attn_impl,
             extra=(), mesh=None):
    """The port's LiveTrainer over a dataset of one pre-collated sample
    (``extra``: more of its arguments; ``mesh``: a mesh of its own)."""
    from videollm_online_tpu_torch.core.arguments import parse_args
    from videollm_online_tpu_torch.train.trainer import LiveTrainer
    args = parse_args(["--max_steps", str(steps), "--logging_steps", "1",
                       "--gradient_accumulation_steps", "1",
                       "--dataloader_num_workers", "0",
                       "--output_dir", out_dir, *extra])
    return LiveTrainer(params=params, cfg=cfg, tokenizer=tok, args=args,
                       train_dataset=[batch] * (steps + 1),
                       collate_fn=lambda items: items[0], attn_impl=attn_impl,
                       mesh=mesh)


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


def _two_layer_params(cfg, seed):
    """cfg cut to 2 layers and its LoRA parameters from `seed`, with a
    non-zero LoRA B (from seed + 1) so every adapter gets a gradient."""
    import dataclasses
    cfg2 = cfg.replace(llama=dataclasses.replace(cfg.llama, num_layers=2))
    params = _lora_8b_params(cfg2,
                             torch.Generator(device="cuda").manual_seed(seed))
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    for pair in list(params["lora"]["layers"].values()) + [
            params["lora"]["lm_head"]]:
        pair["lora_b"].normal_(0.0, 0.02, generator=gen)
    return cfg2, params


def _fp32_attention(q, k, v, *a, **kw):
    """The plain attention on fp32 copies of q, k and v."""
    from videollm_online_tpu_torch.models import llama
    return llama._attention(q.float(), k.float(), v.float(), *a,
                            **kw).to(q.dtype)


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
    cfg2, params = _two_layer_params(cfg, seed=3)
    tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    cfg32 = cfg2.replace(llama=dataclasses.replace(cfg2.llama,
                                                   dtype="float32"))
    params32 = optim.tree_map(
        lambda x: x.float() if x.is_floating_point() else x, params)
    out = {}
    for name, p, c, impl in (("K2", params, cfg2, auto_attention),
                             ("plain", params, cfg2, llama._attention),
                             ("fp32 attention", params, cfg2, _fp32_attention),
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


def _train_config():
    """The 8B training configuration (LoRA r 128 / alpha 256, dropout 0.05,
    1024-d features) and its tokenizer."""
    from videollm_online_tpu_torch.core.config import (LiveConfig,
                                                       LlamaConfig,
                                                       LoraConfig)
    from videollm_online_tpu_torch.tokenizer.live_tokenizer import (
        LiveTokenizer)
    from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer
    lcfg = LlamaConfig(vocab_size=128256, hidden_size=4096,
                       intermediate_size=14336, num_layers=32, num_heads=32,
                       num_kv_heads=8, head_dim=128, dtype="bfloat16")
    cfg = LiveConfig(llama=lcfg, lora=LoraConfig(r=128, alpha=256,
                                                 dropout=0.05),
                     vision_hidden_size=1024)
    tok = LiveTokenizer(ByteTokenizer(), cfg)
    return tok.cfg, tok


def phase_train_seeds(seq: int = 4096):
    """The 2-layer step's loss at TRAIN_SEEDS through K2, the plain
    attention and the plain attention in fp32: how far two correct bf16
    attentions part, which TRAIN_BF16_LOSS_TOL must hold (run alone with
    --phases train_seeds)."""
    from videollm_online_tpu_torch.models import llama
    from videollm_online_tpu_torch.ops.auto import auto_attention
    from videollm_online_tpu_torch.train import step as step_mod
    cfg, _ = _train_config()
    batch, _ = synthetic_batch(cfg, seq, np.random.RandomState(0))
    tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    for seed in TRAIN_SEEDS:
        cfg2, params = _two_layer_params(cfg, seed)
        loss = {}
        with torch.no_grad():
            for name, impl in (("K2", auto_attention),
                               ("plain", llama._attention),
                               ("fp32 attention", _fp32_attention)):
                state, frozen = step_mod.init_train_state(params)
                loss[name] = float(step_mod.loss_fn(
                    state.trainable, frozen, cfg2, tb, attn_impl=impl,
                    dropout_seed=7))

        def rel(a, b):
            return (loss[a] - loss[b]) / abs(loss[b])

        log(f"2-layer 8B-width step, seed {seed}: loss " + ", ".join(
            f"{k} {v:.6f}" for k, v in loss.items())
            + f"; relative K2 - plain {rel('K2', 'plain'):+.3e}, plain - "
              f"fp32 attention {rel('plain', 'fp32 attention'):+.3e}")
        del params
        torch.cuda.empty_cache()


def phase_main_training(steps: int = 4, seq: int = 4096):
    """The training main path: the 8B int8 base (random, built on the
    card), LoRA r 128 / alpha 256 on the seven projections and lm_head
    with dropout 0.05, the connector from 1024-d features, one synthetic
    live1+ sample of T = 4096, through LiveTrainer with remat on."""
    from videollm_online_tpu_torch.ops.auto import auto_attention
    from videollm_online_tpu_torch.train import optim
    cfg, tok = _train_config()
    lcfg = cfg.llama
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
    _SINGLE_RANK["train_8b"] = [r["loss"] for r in logs]
    tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    _profile_step(trainer, tb)
    step_ms = [1e3 / r["steps_per_sec"] for r in logs[1:]]
    del trainer, tb
    torch.cuda.empty_cache()
    _two_layer_parity(cfg, batch)
    return {"launches": counts, "step_ms": step_ms, "peak": peak}


# --------------------------------------------------------------- phase 25
# Training's memory-fit mechanisms at the reference's longest live1+
# sample: phase 8's configuration at T 12288, three steps a run.
FIT_SEQ = 12288
FIT_STEPS = 3
FIT_MLP_CHUNK = 3072
# the runs' losses against the baseline's, relative: phase 8's bound for
# two correct bf16 attentions (the sliced MLP's and the tiled head's
# products sum in another order)
FIT_LOSS_REL = TRAIN_BF16_LOSS_TOL
# query rows a block of the plain K2 versions at T 12288: their fp32
# (Hq, rows, T) scores, probabilities and gradients fit in a few GiB
FIT_PLAIN_ROWS = 1024
# K2 against its plain versions at T 12288. Both round each P term to
# bf16 before its product with dO; where their fp32 P differ by an ulp
# across a bf16 rounding boundary, one term of dV (or, through dS, of dK
# and dQ) moves by a bf16 step of P times |dO|. The large P terms sit on
# the first few hundred keys, so that is where the needed atol lives.
# `--phases k2_fit_probe` read, on an H100 80GB HBM3 at 700 W, over seeds
# 25 and 26 at T 4096 and 12288: dV 2.05e-4 to 2.64e-3 (the largest on key
# 29, |err| 3.4e-3: a P near 0.4, whose bf16 step is 2^-9, times |dO| near
# 1.75), dK up to 5.1e-4, dQ up to 1.1e-3; the needed atol moves with the
# seed, not with T. So the limit is a step of 2^-9 times |dO| up to 1.8;
# K2_TOL's rtol and relative norm bound stay.
FIT_K2_TOL = {**K2_TOL[torch.bfloat16], "atol": 3.5e-3}
# ... and against the exact function in fp64 on kv head 0 (P unrounded),
# where kernel and plain version read the same atol and relative norm to
# three digits: the kernel may be no farther from it than this times the
# plain version's distance.
FIT_K2_FP64_RATIO = 1.1


@contextlib.contextmanager
def _untiled_head():
    """The chunked CE loss with the whole int8 head cast on every call, as
    before the column-tiled head (run (a)'s baseline)."""
    from videollm_online_tpu_torch.models import quant
    tiles = quant.head_tile_cols
    quant.head_tile_cols = lambda v, max_tile=32768: None
    try:
        yield
    finally:
        quant.head_tile_cols = tiles


def _k2_plain_rows(q, k, v, do, scale, rows):
    """K2's plain versions at causal T = S, computed a block of query rows
    at a time (flash_attention_fwd_reference with the block's q_offset;
    flash_bwd_plain's algorithm with dK and dV summed over the blocks in
    fp32 and cast once): out, lse, delta, dq, dk, dv."""
    from videollm_online_tpu_torch.ops import flash_attention as fa
    B, Hq, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    outs, lses = [], []
    for r in range(0, T, rows):
        o, l = fa.flash_attention_fwd_reference(q[:, :, r:r + rows], k, v,
                                                scale, True, r)
        outs.append(o)
        lses.append(l)
    out, lse = torch.cat(outs, 2), torch.cat(lses, 2)
    delta = fa.softmax_delta(do, out)
    kf, vf = fa._grouped(k, G).float(), fa._grouped(v, G).float()
    dk = torch.zeros(B, Hq, S, d, device=q.device)
    dv = torch.zeros_like(dk)
    dq = torch.empty_like(q)
    for r in range(0, T, rows):
        n = min(rows, T - r)
        qb, dob = q[:, :, r:r + n], do[:, :, r:r + n]
        mask = fa.visible_mask(n, S, r, True, None, S, q.device)
        s = torch.matmul(qb.float(), kf.transpose(-1, -2)) * scale
        p = torch.where(mask, torch.exp(s - lse[:, :, r:r + n, None]),
                        torch.zeros_like(s))
        del s
        dof = dob.float()
        dv += torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
        ds = p * (torch.matmul(dof, vf.transpose(-1, -2))
                  - delta[:, :, r:r + n, None]) * scale
        del p
        dk += torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                           qb.float())
        dq[:, :, r:r + n] = torch.matmul(ds.to(k.dtype).float(),
                                         kf).to(q.dtype)
        del ds
    dk = dk.reshape(B, Hkv, G, S, d).sum(2).to(k.dtype)
    dv = dv.reshape(B, Hkv, G, S, d).sum(2).to(v.dtype)
    return out, lse, delta, dq, dk, dv


def _k2_fit_hold(T=FIT_SEQ):
    """K2's three kernels at the fit runs' shapes (B 1, 32 q / 8 kv heads,
    T = S = T, d 128, bf16, causal) against their plain versions (a block
    of query rows at a time; the backward kernels take the plain forward's
    lse and delta, as in phase 6), then each timed by CUDA events beside
    the plain version, SDPA (its forward; its backward, fwd+bwd minus fwd;
    on K and V expanded to the query heads, whose GQA form may take the
    math route at this T) and the bound."""
    from videollm_online_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(25)
    B, Hq, Hkv, d = 1, 32, 8, 128
    q, k, v, do = _k2_inputs(B, Hq, Hkv, T, T, d, torch.bfloat16, gen)
    scale = d ** -0.5
    t0 = time.perf_counter()
    ref_out, ref_lse, delta, ref_dq, ref_dk, ref_dv = _k2_plain_rows(
        q, k, v, do, scale, FIT_PLAIN_ROWS)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    out, lse = fa.flash_fwd(q, k, v, scale)
    dk, dv = fa.flash_dkdv(q, k, v, do, ref_lse, delta, scale)
    dq = fa.flash_dq(q, k, v, do, ref_lse, delta, scale)
    tol = FIT_K2_TOL
    label = f"T = S = {T} (B 1, Hq 32, Hkv 8, d 128, bf16, causal)"
    r = {name: _close(f"{kern} {label} {name}", got, want,
                      K2_LSE_TOL if name == "lse" else tol)
         for kern, name, got, want in (
             ("K2f", "out", out, ref_out), ("K2f", "lse", lse, ref_lse),
             ("K2b", "dk", dk, ref_dk), ("K2b", "dv", dv, ref_dv),
             ("K2q", "dq", dq, ref_dq))}
    log(f"K2 vs plain at {label}, the plain versions {FIT_PLAIN_ROWS} "
        f"query rows at a time ({plain_s:.1f} s; tolerance {tol}, lse "
        f"{K2_LSE_TOL}):")
    for name, reading in r.items():
        log(f"  {name}: {_readings(reading)}")
    for name, got, want in (("dk", dk, ref_dk), ("dv", dv, ref_dv),
                            ("dq", dq, ref_dq)):
        idx, ref_abs, err, buckets = _k2_where(got, want, tol["rtol"])
        log(f"  {name} worst at (b, h, pos, dim) {idx}, |ref| {ref_abs:.3g},"
            f" |err| {err:.3g}; atol needed by position "
            + ", ".join(f"{b} {x:.3g}" for b, x in buckets.items()))
    G = Hq // Hkv
    xq, xk, xv = _k2_fp64_head(q, k, v, do, scale)
    for name, got, want, exact in (("dk", dk[0, 0], ref_dk[0, 0], xk),
                                   ("dv", dv[0, 0], ref_dv[0, 0], xv),
                                   ("dq", dq[0, :G], ref_dq[0, :G], xq)):
        kx, px = (_k2_vs(t, exact, tol["rtol"]) for t in (got, want))
        log(f"  {name} of kv head 0 against fp64: kernel atol needed "
            f"{kx['atol']:.3g}, rel {kx['rel']:.3g}; plain atol needed "
            f"{px['atol']:.3g}, rel {px['rel']:.3g} (ratio bound "
            f"{FIT_K2_FP64_RATIO})")
        if kx["atol"] > FIT_K2_FP64_RATIO * px["atol"] or \
                kx["rel"] > FIT_K2_FP64_RATIO * px["rel"]:
            raise AssertionError(f"K2 {name} at T {T}: farther from the "
                                 f"fp64 function than the plain version: "
                                 f"{kx} against {px}")
    del out, dk, dv, dq, ref_out, ref_dq, ref_dk, ref_dv, xq, xk, xv
    torch.cuda.empty_cache()
    F = torch.nn.functional
    kx, vx = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (k, v))
    qg, kg, vg = (t.detach().clone().requires_grad_(True)
                  for t in (q, kx, vx))

    def sdpa_fwd(_):
        return F.scaled_dot_product_attention(q, kx, vx, is_causal=True,
                                              scale=scale)

    def sdpa_fwd_bwd(_):
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                       scale=scale).backward(do)

    t = {"fwd": cuda_ms(lambda _: fa.flash_fwd(q, k, v, scale), 10, 2),
         "dkdv": cuda_ms(lambda _: fa.flash_dkdv(q, k, v, do, ref_lse,
                                                 delta, scale), 10, 2),
         "dq": cuda_ms(lambda _: fa.flash_dq(q, k, v, do, ref_lse, delta,
                                             scale), 10, 2),
         "plain": cuda_ms(lambda _: _k2_plain_rows(q, k, v, do, scale,
                                                   FIT_PLAIN_ROWS), 2, 1),
         "sdpa_fwd": cuda_ms(sdpa_fwd, 10, 2)}
    t["sdpa_bwd"] = cuda_ms(sdpa_fwd_bwd, 10, 2) - t["sdpa_fwd"]
    pairs = B * Hq * T * (T + 1) // 2
    q_bytes, kv_bytes, row_bytes = q.numel() * 2, k.numel() * 2, B * Hq * T * 4
    work = {"fwd": (4 * d * pairs, 2 * q_bytes + 2 * kv_bytes + row_bytes),
            "dkdv": (8 * d * pairs, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
            "dq": (6 * d * pairs, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes)}
    res = {}
    for name, (flops, bytes_) in work.items():
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        res[name] = {"ms": t[name], "plain_ms": t["plain"],
                     "library_ms": t["sdpa_fwd" if name == "fwd"
                                     else "sdpa_bwd"],
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "tflops": flops / t[name] / 1e9}
    res["fwd"]["max_abs_err"] = max(r["out"]["max"], r["lse"]["max"])
    res["dkdv"]["max_abs_err"] = max(r["dk"]["max"], r["dv"]["max"])
    res["dq"]["max_abs_err"] = r["dq"]["max"]
    for name, x in res.items():
        log(f"K2 {name} at T {T}: {x['ms']:.4f} ms, {x['tflops']:.1f} "
            f"TFLOP/s, bound {x['bound_ms']:.4f} ms ({x['bound_by']}, "
            f"{100 * x['bound_ms'] / x['ms']:.1f} %), SDPA "
            f"{x['library_ms']:.4f} ms, plain (forward and backward, by "
            f"blocks) {x['plain_ms']:.1f} ms")
    del q, k, v, do, kx, vx, qg, kg, vg, ref_lse, delta
    torch.cuda.empty_cache()
    return res


# position buckets of _k2_where: the first keys (whose dV and dK sum the
# most query rows), then wider bands
K2_BUCKETS = (0, 16, 256, 1024, 4096, 8192, 12288)


def _k2_where(got, want, rtol, rows_axis=2):
    """Where an output of K2 needs its atol at ``rtol``: (the worst
    element's index (B, H, position, dim), its |want| and |got - want|,
    the needed atol by position bucket of K2_BUCKETS)."""
    g, w = got.float(), want.float()
    need = ((g - w).abs() - rtol * w.abs()).clamp(min=0)
    idx = tuple(int(i) for i in np.unravel_index(int(need.argmax()),
                                                 need.shape))
    n = need.shape[rows_axis]
    edges = [e for e in K2_BUCKETS if e < n] + [n]
    buckets = {f"{a}-{b}": float(need.narrow(rows_axis, a, b - a).max())
               for a, b in zip(edges, edges[1:])}
    return idx, float(w[idx].abs()), float((g - w)[idx].abs()), buckets


def _k2_fp64_head(q, k, v, do, scale, rows=1024):
    """The exact function in fp64 for kv head 0 and its G query heads of a
    causal T = S attention (P unrounded, its own lse and delta): dq (G, T,
    d), dk (S, d), dv (S, d)."""
    Hq, Hkv = q.shape[1], k.shape[1]
    G = Hq // Hkv
    qh, doh = q[0, :G].double(), do[0, :G].double()
    kh, vh = k[0, 0].double(), v[0, 0].double()
    T = qh.shape[1]
    pos = torch.arange(T, device=q.device)
    lse = torch.empty(G, T, dtype=torch.float64, device=q.device)
    delta = torch.empty_like(lse)

    def probs(r, n):
        s = torch.matmul(qh[:, r:r + n], kh.T) * scale
        return s.masked_fill(pos[None, :] > pos[r:r + n, None],
                             float("-inf"))
    for r in range(0, T, rows):
        n = min(rows, T - r)
        s = probs(r, n)
        lse[:, r:r + n] = torch.logsumexp(s, -1)
        out = torch.matmul(torch.exp(s - lse[:, r:r + n, None]), vh)
        delta[:, r:r + n] = (doh[:, r:r + n] * out).sum(-1)
    dk = torch.zeros_like(kh)
    dv = torch.zeros_like(vh)
    dq = torch.empty_like(qh)
    for r in range(0, T, rows):
        n = min(rows, T - r)
        p = torch.exp(probs(r, n) - lse[:, r:r + n, None])
        dob = doh[:, r:r + n]
        dv += torch.matmul(p.transpose(-1, -2), dob).sum(0)
        ds = p * (torch.matmul(dob, vh.T) - delta[:, r:r + n, None]) * scale
        dk += torch.matmul(ds.transpose(-1, -2), qh[:, r:r + n]).sum(0)
        dq[:, r:r + n] = torch.matmul(ds, kh)
    return dq, dk, dv


def _k2_vs(got, want, rtol):
    g, w = got.double(), want.double()
    err = (g - w).abs()
    return {"max": float(err.max()),
            "atol": max(float((err - rtol * w.abs()).max()), 0.0),
            "rel": float((g - w).norm() / w.norm())}


def phase_k2_fit_probe(lengths=(4096, FIT_SEQ), seeds=(25, 26)):
    """Where K2's backward parts from its plain version at the fit
    runs' shape, and why (not in the default run): for T 4096 and 12288
    and two seeds, K2b / K2q against the plain versions (a block of query
    rows at a time, as phase 25 holds them): the worst element of dK, dV
    and dQ, its |ref|, and the atol needed by position bucket; then for kv
    head 0 and its 4 query heads, kernel and plain version each against
    the exact function in fp64 (P unrounded), so a gap that is the two
    roundings' shows as kernel and plain equally far from fp64."""
    from videollm_online_tpu_torch.ops import flash_attention as fa
    card = _card()
    rtol = FIT_K2_TOL["rtol"]
    B, Hq, Hkv, d = 1, 32, 8, 128
    G = Hq // Hkv
    scale = d ** -0.5
    out = {}
    for T in lengths:
        for seed in seeds:
            gen = torch.Generator(device="cuda").manual_seed(seed)
            q, k, v, do = _k2_inputs(B, Hq, Hkv, T, T, d, torch.bfloat16,
                                     gen)
            _, lse, delta, ref_dq, ref_dk, ref_dv = _k2_plain_rows(
                q, k, v, do, scale, FIT_PLAIN_ROWS)
            dk, dv = fa.flash_dkdv(q, k, v, do, lse, delta, scale)
            dq = fa.flash_dq(q, k, v, do, lse, delta, scale)
            log(f"K2 backward at T = S = {T}, seed {seed}, kernel against "
                f"the plain version (rtol {rtol}) [{card}]:")
            res = {}
            for name, got, want in (("dk", dk, ref_dk), ("dv", dv, ref_dv),
                                    ("dq", dq, ref_dq)):
                idx, ref_abs, err, buckets = _k2_where(got, want, rtol)
                res[name] = {"worst": idx, "ref": ref_abs, "err": err,
                             "buckets": buckets,
                             "vs_plain": _k2_vs(got, want, rtol)}
                terms = ""
                if name == "dv":
                    # the magnitude of the worst element's terms: sum over
                    # its query rows of |P dO| in its kv head's group
                    _, h, j, c = idx
                    hs = slice(h * G, (h + 1) * G)
                    sc = torch.matmul(q[0, hs, j:].float(),
                                      k[0, h, j].float()) * scale
                    pj = torch.exp(sc - lse[0, hs, j:])
                    mag = float((pj * do[0, hs, j:, c].float()).abs().sum())
                    res[name]["terms"] = mag
                    terms = (f", sum of its |P dO| terms {mag:.3g} over "
                             f"{T - j} query rows")
                log(f"  {name}: worst at (b, h, pos, dim) {idx}, |ref| "
                    f"{ref_abs:.3g}, |err| {err:.3g}{terms}; atol needed "
                    f"by position "
                    + ", ".join(f"{b} {x:.3g}" for b, x in buckets.items()))
            xq, xk, xv = _k2_fp64_head(q, k, v, do, scale)
            for name, got, want, exact in (
                    ("dk", dk[0, 0], ref_dk[0, 0], xk),
                    ("dv", dv[0, 0], ref_dv[0, 0], xv),
                    ("dq", dq[0, :G], ref_dq[0, :G], xq)):
                kx, px = _k2_vs(got, exact, rtol), _k2_vs(want, exact, rtol)
                res[name]["kernel_vs_fp64"], res[name]["plain_vs_fp64"] = \
                    kx, px
                log(f"  {name} of kv head 0 against fp64: kernel max "
                    f"{kx['max']:.3g}, atol needed {kx['atol']:.3g}, rel "
                    f"{kx['rel']:.3g}; plain max {px['max']:.3g}, atol "
                    f"needed {px['atol']:.3g}, rel {px['rel']:.3g}")
            out[T, seed] = res
            del q, k, v, do, lse, delta, ref_dq, ref_dk, ref_dv, dk, dv, dq
            torch.cuda.empty_cache()
    return out


def _moments_on_card(state) -> int:
    """Bytes of the Adam moments that live on the card."""
    from videollm_online_tpu_torch.train import optim
    return sum(x.numel() * x.element_size() for x in optim.tree_leaves(
        {"mu": state.opt_state.mu, "nu": state.opt_state.nu}) if x.is_cuda)


def phase_main_path_fit(seq: int = FIT_SEQ, steps: int = FIT_STEPS):
    """Training's memory-fit mechanisms on phase 8's configuration (the
    8B int8 base built at random on the card, LoRA r 128 / alpha 256 with
    dropout 0.05, the connector, the chunked CE loss) at one live1+ sample
    of T 12288, through LiveTrainer, ``steps`` steps a run from the same
    weights: (a) per-layer remat and the whole int8 head cast each call;
    (b) the JAX package's fit recipe, ``--remat_group 2 --mlp_chunk
    3072`` and the column-tiled head; (c) ``--offload_optimizer
    --remat_group 2`` (the in-step variant); (d) ``--remat_group 2``
    alone, which (c)'s trainables, moments and losses must equal bit for
    bit after the last step. Each run: ms/step over the
    steps after the first, tokens/s, peak memory, the memory held between
    steps, a profile of one more step by kernel class ((a) to (c)), K2
    launches a step
    (K2f 2L under per-layer remat, 2L + L/2
    under remat_group 2: the outer recompute stops after the group's
    last layer input; K2b and K2q L), and for (c) the bytes moved each way
    a step. The losses of (b), (c) and (d) are held to (a)'s within
    FIT_LOSS_REL, and (c) must keep no moment on the card between steps.
    Then K2's three kernels at T 12288 against their plain versions, and
    kernel and plain version against the fp64 function on kv head 0."""
    from videollm_online_tpu_torch.ops.auto import auto_attention
    from videollm_online_tpu_torch.train import optim
    card = _card()
    cfg, tok = _train_config()
    L = cfg.llama.num_layers
    batch, n_frames = synthetic_batch(cfg, seq, np.random.RandomState(0))
    t0 = time.perf_counter()
    params = _lora_8b_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"fit runs: the 8B int8 base + LoRA r 128 built in "
        f"{time.perf_counter() - t0:.2f} s; sample T {seq}, {n_frames} "
        f"frames, {steps} steps a run, chunked CE loss [{card}]")
    sliced = cfg.replace(llama=dataclasses.replace(cfg.llama,
                                                   mlp_chunk=FIT_MLP_CHUNK))
    runs = (("a", cfg, (), False),
            ("b", sliced, ("--remat_group", "2", "--mlp_chunk",
                           str(FIT_MLP_CHUNK)), True),
            ("c", cfg, ("--offload_optimizer", "true", "--remat_group", "2"),
             True),
            ("d", cfg, ("--remat_group", "2"), True))
    res, launches = {}, {k: 0 for k in ("K2f", "K2b", "K2q")}
    after = {}
    for name, rcfg, extra, tiled in runs:
        out_dir = _out_dir(f"fit_{name}")
        trainer = _trainer(params, rcfg, tok, out_dir, batch, steps,
                           auto_attention, extra=("--chunked_loss", "true",
                                                  *extra))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        with contextlib.nullcontext() if tiled else _untiled_head():
            trainer.train()
            torch.cuda.synchronize()
            counts = _read_launches()
            peak = torch.cuda.max_memory_allocated()
            held = torch.cuda.memory_allocated()
            on_card = _moments_on_card(trainer.state)
            moved = (dict(trainer._offload_step.moved)
                     if trainer._offload_step is not None else None)
            if name in ("c", "d"):
                # the trained state, copied before anything steps again
                # (the offloaded moments are updated in place)
                after[name] = [x.detach().to("cpu", copy=True)
                               for x in optim.tree_leaves(
                                   {"p": trainer.state.trainable,
                                    "mu": trainer.state.opt_state.mu,
                                    "nu": trainer.state.opt_state.nu})]
            if name != "d":
                log(f"fit run ({name}), one more step profiled:")
                _profile_step(trainer, {k: torch.from_numpy(v).cuda()
                                        for k, v in batch.items()})
        logs = _logged(out_dir)
        G = trainer.args.remat_group
        per_step = {k: counts[k] / steps for k in launches}
        want = {"K2f": 2 * L + (L - L // G if G > 1 else 0), "K2b": L,
                "K2q": L}
        if per_step != want:
            raise AssertionError(f"run ({name}): K2 launches a step "
                                 f"{per_step}, want {want}")
        if len(logs) != steps or not all(np.isfinite(r["loss"])
                                         for r in logs):
            raise AssertionError(f"run ({name}): bad losses {logs}")
        step_ms = [1e3 / r["steps_per_sec"] for r in logs[1:]]
        res[name] = {"losses": [r["loss"] for r in logs],
                     "ms": float(np.mean(step_ms)), "peak": peak,
                     "held": held, "moments_on_card": on_card,
                     "launches": per_step, "moved": moved,
                     "n_train": optim.count_params(trainer.state.trainable),
                     "moment_bytes": sum(
                         x.numel() * x.element_size()
                         for x in optim.tree_leaves(
                             {"mu": trainer.state.opt_state.mu,
                              "nu": trainer.state.opt_state.nu}))}
        for k in launches:
            launches[k] += counts[k]
        log(f"fit run ({name}) {' '.join(extra) or 'per-layer remat'}"
            f"{', tiled head' if tiled else ', untiled head'}: losses "
            + ", ".join(f"{x:.6f}" for x in res[name]["losses"])
            + f"; {res[name]['ms']:.1f} ms/step over steps 2-{steps} "
              f"({', '.join(f'{x:.1f}' for x in step_ms)}), "
              f"{seq / res[name]['ms'] * 1e3:.1f} tokens/s; peak "
              f"{peak / 2**30:.2f} GiB, held between steps "
              f"{held / 2**30:.2f} GiB (moments on the card "
              f"{on_card / 2**30:.3f} GiB); K2 launches a step {per_step}"
            + (f"; moved a step {moved['to_device'] / steps / 2**30:.3f} "
               f"GiB to the card, {moved['to_host'] / steps / 2**30:.3f} "
               f"GiB to the host" if moved else "") + f" [{card}]")
        del trainer
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    base = res["a"]["losses"]
    for name in ("b", "c", "d"):
        rel = max(abs(x - y) / abs(y) for x, y in zip(res[name]["losses"],
                                                      base))
        log(f"fit run ({name}) losses against (a)'s: relative {rel:.3e} "
            f"(bound {FIT_LOSS_REL})")
        if rel > FIT_LOSS_REL:
            raise AssertionError(f"run ({name}) losses {res[name]['losses']}"
                                 f" part from (a)'s {base}")
    # (c)'s offloaded update against (d), the same run with the moments on
    # the card: every trainable and moment bit for bit, and the losses
    differ = [i for i, (x, y) in enumerate(zip(after["c"], after["d"]))
              if not torch.equal(x, y)]
    log(f"fit run (c) against (d) --remat_group 2 without offload, after "
        f"{steps} steps: {len(after['c'])} leaves of trainables and "
        f"moments, {len(differ)} differ; losses "
        f"{res['c']['losses']} against {res['d']['losses']}")
    if differ or res["c"]["losses"] != res["d"]["losses"]:
        worst = max((float((after["c"][i].float()
                            - after["d"][i].float()).abs().max())
                     for i in differ), default=0.0)
        raise AssertionError(f"run (c) parts from (d): leaves {differ}, "
                             f"max abs {worst}, losses {res['c']['losses']}"
                             f" against {res['d']['losses']}")
    del after
    if res["c"]["moments_on_card"] or not res["c"]["moved"]["to_device"]:
        raise AssertionError(f"run (c) keeps {res['c']['moments_on_card']} "
                             f"bytes of moments on the card, moved "
                             f"{res['c']['moved']}")
    log(f"fit: trainable parameters {res['a']['n_train'] / 1e6:.1f} M, "
        f"Adam moments {res['a']['moment_bytes'] / 2**30:.3f} GiB; "
        + "; ".join(f"({n}) peak {r['peak'] / 2**30:.2f} GiB, held "
                    f"{r['held'] / 2**30:.2f} GiB, {r['ms']:.1f} ms/step"
                    for n, r in res.items()) + f" [{card}]")
    k2 = _k2_fit_hold(seq)
    return {"launches": launches, "runs": res, "k2": k2}



# ---------------------------------------------------------------- phase 9
# The fused-MLP kernels against their plain versions (_close's readings).
# The MLP outputs are in x's dtype and of magnitude about 0.5; K5's are fp32
# and of magnitude about 0.7. Kernel and plain version round x and h to bf16
# alike and differ in the order of the fp32 sums, which moves an h value, and
# through it a bf16 output, by an ulp in a few places. The bounds sit above
# the readings over this phase's cases: bf16 outputs need an atol up to
# 1.2e-3 at rtol 2e-2 and read a relative norm error up to 6.3e-4 (K6 at
# 128 rows); fp32 outputs read a max error of 3.6e-5 on values of magnitude
# 5.6 and 2.4e-7 relative; K5 needs an atol up to 2.9e-7 and reads 1.3e-7.
FUSED_TOL = {"mlp_bf16": {"atol": 4e-3, "rtol": 2e-2, "rel": 2e-3},
             "mlp_fp32": {"atol": 1e-3, "rtol": 1e-3, "rel": 1e-4},
             "matmul": {"atol": 1e-5, "rtol": 1e-5, "rel": 1e-6}}
FUSED_KERNELS = {
    "K4": ("fused_mlp_int4c", "q4c",
           "videollm_online_tpu/ops/fused_mlp.py:370"),
    "K5": ("matmul_int4c", "q4c",
           "videollm_online_tpu/ops/fused_mlp.py:428"),
    "K6": ("fused_mlp_int8", "q8",
           "videollm_online_tpu/ops/fused_mlp.py:76"),
    "K7": ("fused_mlp_int4", "q4p",
           "videollm_online_tpu/ops/fused_mlp.py:221"),
}


def _rand_quantized(layout, K, N, gen, layers=1, group=128):
    """Random packed bytes over the whole int8 range (every byte is valid
    int4 data) and random positive scales sized for outputs of magnitude
    about 1 from unit-variance inputs; stacked over ``layers``."""
    shape, low, std = {"q4c": ((K, N // 2), -128, 4.6),
                       "q4p": ((K // 2, N), -128, 4.6),
                       "q8": ((K, N), -127, 73.0)}[layout]
    w = torch.randint(low, 128, (layers,) + shape, generator=gen,
                      device="cuda", dtype=torch.int8)
    s_shape = (layers, N) if layout == "q8" else (layers, K // group, N)
    s = (0.5 + torch.rand(s_shape, generator=gen, device="cuda")) / (
        std * K ** 0.5)
    return w, s


def _dequant_route(layout, x, mats):
    """The route the dispatch declines to, with no kernel of this family in
    it: three (or one) matmuls over weights dequantized in x's dtype, as
    models/quant.quantized_matmul takes them."""
    from videollm_online_tpu_torch.models import quant

    def mm(inp, i):
        w, scale = mats[2 * i], mats[2 * i + 1]
        if layout == "q8":
            return quant._qmm(inp, w, scale)
        if layout == "q4c":
            return inp @ quant._dequantize_int4c(
                {quant.QUANT4C_KEY: w, "scale": scale}, inp.dtype)
        return inp @ quant._dequantize_int4(
            {quant.QUANT4_KEY: w, "scale": scale}, inp.dtype)

    if len(mats) == 2:
        return mm(x, 0)
    return mm(torch.nn.functional.silu(mm(x, 0)) * mm(x, 1), 2)


def _fused_fns(label):
    from videollm_online_tpu_torch.ops import fused_mlp as fm
    name = FUSED_KERNELS[label][0]
    return getattr(fm, name), getattr(fm, name + "_reference")


def _fused_case(label, x, mats, tol_key, what):
    """One kernel against its plain version on one input; the kernel run
    twice must give equal bits."""
    kern, plain = _fused_fns(label)
    got = kern(x, *mats)
    again = kern(x, *mats)
    want = plain(x, *mats)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{label} {what}: two runs of one input differ")
    return _close(f"{label} {what}", got, want, FUSED_TOL[tol_key])


def _fused_mats(label, D, F, V, gen, layers):
    """Stacked weights of `layers` MLPs (or heads) at the given widths."""
    layout = FUSED_KERNELS[label][1]
    if label == "K5":
        return [_rand_quantized(layout, D, V, gen, layers)]
    return [_rand_quantized(layout, D, F, gen, layers),
            _rand_quantized(layout, D, F, gen, layers),
            _rand_quantized(layout, F, D, gen, layers)]


def _fused_bound(label, B, D, F, V, mats):
    """The least time for one call on the weights and scales `mats`: every
    input read once and the output written once over the memory rate,
    against the products' operations over the bf16 tensor-core rate."""
    bytes_ = sum(t.numel() * t.element_size() for t in mats)
    if label == "K5":
        bytes_ += B * D * 2 + B * V * 4
        flops = 2 * B * D * V
    else:
        bytes_ += 2 * B * D * 2
        flops = 2 * B * 3 * D * F
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "mbytes": bytes_ / 1e6}


def _library_fn(label, mats):
    """One PyTorch call on the card for K5's function (tinygemm,
    ``_weight_int4pack_mm``, on the same integers repacked by
    ``_convert_weight_to_int4pack``, zero point 8, scales rounded to bf16)
    and for K6's products (three ``_weight_int8pack_mm`` around silu * up,
    in bf16), timed beside the kernels and used nowhere in the port; None
    for the other kernels."""
    from videollm_online_tpu_torch.models import quant
    if label == "K5":
        w, s = mats
        K, N = w.shape[0], s.shape[-1]
        q = (quant._unpack_int4c(w, torch.int32) + 8).t().contiguous()
        packed = torch.ops.aten._convert_weight_to_int4pack(
            (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8), 8)
        del q
        sz = torch.stack([s, torch.zeros_like(s)], -1).to(
            torch.bfloat16).contiguous()
        group = K // s.shape[0]
        return lambda x: torch.ops.aten._weight_int4pack_mm(x, packed, group,
                                                            sz)
    if label == "K6":
        wg, sg, wu, su, wd, sd = mats
        wt = [m.t().contiguous() for m in (wg, wu, wd)]
        sb = [m.to(torch.bfloat16) for m in (sg, su, sd)]
        mm = torch.ops.aten._weight_int8pack_mm

        def mlp(x):
            g, u = mm(x, wt[0], sb[0]), mm(x, wt[1], sb[1])
            return mm(torch.nn.functional.silu(g) * u, wt[2], sb[2])
        return mlp
    return None


def _library_ms(label, x, per_layer, want):
    """The library call's ms a call (CUDA-graph replay over the layers'
    weights) and its largest error against the plain version, or (None,
    why it does not run)."""
    try:
        fns = [_library_fn(label, m) for m in per_layer]
        if fns[0] is None:
            return None, "no library call"
        got = fns[0](x)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ms = graph_ms(lambda i: fns[i % len(fns)](x), len(fns))
        return ms, f"max error {err:.3g} against the plain version"
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        return None, f"does not run: {str(e).splitlines()[0][:160]}"


def _routes(label):
    """K5's, K6's and K7's two routes called directly: the streaming core
    and the mma.sync family."""
    from videollm_online_tpu_torch.ops import fused_mlp as fm
    if label == "K5":
        return {"streaming": lambda x, *m: fm._launch_matmul(x, *m, True),
                "mma.sync": lambda x, *m: fm._launch_matmul(x, *m, False)}
    if label in ("K6", "K7"):
        layout = fm.LAYOUT_Q8 if label == "K6" else fm.LAYOUT_Q4P
        return {"streaming": lambda x, *m: fm._launch_wo_mlp(layout, x, *m),
                "mma.sync": lambda x, *m: fm._launch_mlp(layout, x, *m)}
    return {}


def _fused_small_cases(gen):
    """Odd shapes on real quantized weights: groups below 128, byte rows
    that are not a multiple of 16 or of the column tile, an odd number of
    groups (row-packed halves that straddle a group: K7 on the mma.sync
    family), K7 on the streaming core with groups of 64 and 32 and strip
    tails, every row configuration, fp32 and bf16 x."""
    from videollm_online_tpu_torch.models import quant

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    qfn = {"K4": quant.quantize_weight_int4c, "K5": quant.quantize_weight_int4c,
           "K7": quant.quantize_weight_int4,
           "K6": lambda w, group=None: quant.quantize_weight(w, axis=-2)}
    worst = {}
    cases = (
        # label, rows, D, F (or N for K5), group, x dtype
        ("K4", 3, 64, 128, 128, torch.float32),      # tiny_live_config
        ("K4", 17, 192, 320, 64, torch.bfloat16),
        ("K4", 5, 48, 80, 16, torch.bfloat16),       # 40-byte rows
        ("K4", 70, 256, 512, 128, torch.bfloat16),
        ("K4", 128, 128, 384, 128, torch.float32),
        ("K4", 12, 256, 512, 64, torch.bfloat16),    # wgmma N 16
        ("K4", 40, 192, 320, 64, torch.float32),     # wgmma N 64
        ("K5", 1, 64, 512, 128, torch.float32),
        ("K5", 33, 128, 1000, 64, torch.bfloat16),   # 500-byte rows
        ("K5", 128, 256, 2048, 128, torch.bfloat16),
        ("K7", 2, 128, 192, 64, torch.bfloat16),     # 3 groups of F
        ("K7", 40, 384, 256, 128, torch.float32),    # 3 groups of D
        ("K7", 100, 96, 160, 32, torch.bfloat16),
        ("K7", 3, 256, 512, 64, torch.bfloat16),     # the streaming core
        ("K7", 7, 320, 1088, 32, torch.bfloat16),    # the core, strip tails
        ("K6", 4, 80, 176, 0, torch.bfloat16),
        ("K6", 64, 144, 48, 0, torch.float32),
    )
    for label, B, D, F, group, dtype in cases:
        key = FUSED_KERNELS[label][1]
        if label == "K5":
            ws = [rnd(D, F) * 0.05]
        else:
            ws = [rnd(D, F) * 0.05, rnd(D, F) * 0.05, rnd(F, D) * 0.05]
        mats = []
        for w in ws:
            q = qfn[label](w, group=group)
            mats += [q[key], q["scale"]]
        x = rnd(B, D).to(dtype) * (4.0 if label != "K5" else 1.0)
        tol_key = ("matmul" if label == "K5" else
                   "mlp_fp32" if dtype == torch.float32 else "mlp_bf16")
        r = _fused_case(label, x, mats, tol_key,
                        f"B {B} D {D} F {F} group {group} {dtype}")
        prev = worst.get((label, tol_key))
        worst[(label, tol_key)] = r if prev is None else _worst([prev, r])
    for (label, tol_key), r in worst.items():
        log(f"  {label} small cases ({tol_key}): {_readings(r)}")
    return {label: max(r["max"] for (l, _), r in worst.items() if l == label)
            for label in FUSED_KERNELS}


def phase_fused(rows=(1, 20, 91, 128), timed_rows=(1, 20, 91, 128)):
    """K4, K5, K6, K7 against their plain versions at the 8B shapes and on
    small odd cases, and their device time per call (CUDA events around
    replays of a CUDA graph of the calls, so that no host launch cost is in
    it, and around 10 eager calls after 2 warm-ups; each call on the next of
    2 layers' weights so that they come from device memory, not the L2)
    beside the plain version's, the dequantizing route's and the bound.
    K5 also at 8 rows (the gate's logits of a chunk); K5 and K6 on both of
    their routes (the streaming core and the mma.sync family, each held to
    the plain version) and beside one library call for the same function."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    D, F, V, layers = 4096, 14336, 128256, 2
    log(f"fused-MLP kernels vs plain (tolerance {FUSED_TOL}):")
    small = _fused_small_cases(gen)
    out = {}
    for label in ("K4", "K5", "K6", "K7"):
        kern, plain = _fused_fns(label)
        layout = FUSED_KERNELS[label][1]
        stacked = _fused_mats(label, D, F, V, gen, layers)
        per_layer = [[t[l] for pair in stacked for t in pair]
                     for l in range(layers)]
        worst = []
        timing = {}
        routes = _routes(label)
        tol_key = "matmul" if label == "K5" else "mlp_bf16"
        for B in (rows if label != "K5" else sorted({8, *rows})):
            x = torch.randn((B, D), generator=gen, device="cuda").to(
                torch.bfloat16)
            r = _fused_case(label, x, per_layer[0], tol_key,
                            f"8B shapes, {B} rows")
            worst.append(r)
            log(f"  {label} at the 8B shapes, {B} rows: {_readings(r)} "
                f"(two calls on one input give equal bits)")
            want = plain(x, *per_layer[0])
            for route, fn in routes.items():
                rr = _close(f"{label} {route} route, {B} rows",
                            fn(x, *per_layer[0]), want, FUSED_TOL[tol_key])
                worst.append(rr)
                log(f"    {route} route: {_readings(rr)}")
            if B not in timed_rows and not (label == "K5" and B == 8):
                continue
            # the card's clocks recover from the plain version's load first
            graph_ms(lambda i: kern(x, *per_layer[i % layers]), layers,
                     reps=100)
            t = {"ms": graph_ms(lambda i: kern(x, *per_layer[i % layers]),
                                layers),
                 "eager_ms": cuda_ms(
                     lambda i: kern(x, *per_layer[i % layers]), 10, 2),
                 "plain_ms": cuda_ms(
                     lambda i: plain(x, *per_layer[i % layers]), 3, 1),
                 "dequant_route_ms": cuda_ms(
                     lambda i: _dequant_route(layout, x,
                                              per_layer[i % layers]), 10, 2),
                 **_fused_bound(label, B, D, F, V, per_layer[0])}
            t["library_ms"], t["library"] = _library_ms(label, x, per_layer,
                                                        want)
            for route, fn in routes.items():
                t[f"{route}_ms"] = graph_ms(
                    lambda i: fn(x, *per_layer[i % layers]), layers)
            timing[B] = t
            log(f"  {label} at the 8B shapes, {B} rows, device ms per call: "
                f"kernel {t['ms']:.4f} (CUDA-graph replay; called eagerly "
                f"from Python {t['eager_ms']:.4f}), plain "
                f"{t['plain_ms']:.3f}, "
                f"dequantizing route {t['dequant_route_ms']:.4f}, bound "
                f"{t['bound_ms']:.4f} ({t['bound_by']}, {t['mbytes']:.1f} MB "
                f"at {HBM_BYTES_PER_S / 1e12} TB/s): "
                f"{t['ms'] / t['bound_ms']:.2f} x the bound, "
                f"{100 * t['bound_ms'] / t['ms']:.1f}% of it"
                + "".join(f"; {route} route {t[route + '_ms']:.4f}"
                          for route in routes)
                + ("" if t["library_ms"] is None and label not in ("K5", "K6")
                   else f"; library call {t['library_ms']} ({t['library']})"))
        out[label] = {**timing[timed_rows[0]],
                      "max_abs_err": max(small[label],
                                         _worst(worst)["max"])}
        del stacked, per_layer
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------ K4's, K5's, K6's launches
def _route_bytes(label, route, B, mats, sms):
    """The bytes each launch of one call moves, each input read once and
    each output written once, for the route's split counts: K4 and K6 the
    gate/up product, the SwiGLU merge, the down product, the down merge;
    K5 the product and, past one split (or on the mma.sync family), the
    merge; K7 as K4, its scales read by the products."""
    from videollm_online_tpu_torch.ops import fused_mlp as fm

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    if label == "K5":
        w, sc = mats
        K, N = w.shape[0], sc.shape[-1]
        group = K // sc.shape[0]
        if route == "streaming":
            s1 = fm.wo_schedule(fm.LAYOUT_Q4C, K, N // 2, B, group, 1, sms)[1]
        else:
            s1 = fm._split(K, group, N // 2, B, 1, sms)[0]
        if route == "streaming" and s1 == 1:
            return (s1,), [nbytes(w, sc) + B * K * 2 + B * N * 4]
        part = s1 * B * N * 4
        return (s1,), [nbytes(w, sc) + B * K * 2 + part, part + B * N * 4]
    wg, sg, wu, su, wd, sd = mats
    D, F = wg.shape[0], wd.shape[0]
    if label == "K7":
        D, F = 2 * D, 2 * F
        group_d, group_f = D // sg.shape[0], F // sd.shape[0]
        if route == "streaming":
            s1 = fm.wo_schedule(fm.LAYOUT_Q4P, D // 2, F, B, group_d, 2,
                                sms)[1]
            s2 = fm.wo_schedule(fm.LAYOUT_Q4P, F // 2, D, B, group_f, 1,
                                sms)[1]
        else:
            s1 = fm._split(D // 2, group_d, F, B, 2, sms)[0]
            s2 = fm._split(F // 2, group_f, D, B, 1, sms)[0]
        scales = ((sg, su), (wd, sd))
    elif label == "K4":
        group_d, group_f = D // sg.shape[0], F // sd.shape[0]
        if route == "wgmma":
            s1 = fm.q4c_schedule(D, F // 2, B, 2, sms)[1]
            s2 = fm.q4c_schedule(F, D // 2, B, 1, sms)[1]
        else:
            s1 = fm._split(D, group_d, F // 2, B, 2, sms)[0]
            s2 = fm._split(F, group_f, D // 2, B, 1, sms)[0]
        scales = ((sg, su), (wd, sd))
    else:
        if route == "streaming":
            s1 = fm.wo_schedule(fm.LAYOUT_Q8, D, F, B, D, 2, sms)[1]
            s2 = fm.wo_schedule(fm.LAYOUT_Q8, F, D, B, F, 1, sms)[1]
        else:
            s1 = fm._split(D, D, F, B, 2, sms)[0]
            s2 = fm._split(F, F, D, B, 1, sms)[0]
        scales = ((), (wd,))
    part1, part2 = 2 * s1 * B * F * 4, s2 * B * D * 4
    merge1 = nbytes(sg, su) if label == "K6" else 0
    merge2 = nbytes(sd) if label == "K6" else 0
    return (s1, s2), [nbytes(wg, wu, *scales[0]) + B * D * 2 + part1,
                      part1 + merge1 + B * F * 2,
                      nbytes(*scales[1]) + B * F * 2 + part2,
                      part2 + merge2 + B * D * 4]


def _kernel_sequence(fn, calls, per_call):
    """The device kernels of fn's last `calls` calls under torch.profiler,
    as (name, mean us) per launch of one call, fn launching `per_call`
    kernels (the profiler can miss the first launches of its window, so two
    more calls run first); None if it saw fewer."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls + 2):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                     for e in prof.events() if "CUDA" in str(e.device_type))
    if len(kernels) < calls * per_call:
        return None
    kernels = kernels[-calls * per_call:]
    return [(kernels[i][1], sum(kernels[c * per_call + i][2]
                                for c in range(calls)) / calls)
            for i in range(per_call)]


def phase_k4_profile(rows=(1, 20, 91, 128)):
    """One call each of K4, K5, K6 and K7 at the 8B shapes, launch by
    launch, on both routes of each, called directly: K4's wgmma kernel and
    K5's, K6's and K7's streaming core (what the wrappers run at these
    shapes) and the mma.sync family. Per launch its device time under torch.profiler
    (mean of 6 calls on one layer's weights), the bytes it moves and their
    rate; per route the whole call by CUDA-graph replay over 2 layers'
    weights. K5 also at 8 rows."""
    from videollm_online_tpu_torch.ops import fused_mlp as fm
    gen = torch.Generator(device="cuda").manual_seed(4)
    D, F, V, layers = 4096, 14336, 128256, 2
    sms = fm._sm_count(torch.device("cuda"))
    out = {}
    for label in ("K4", "K5", "K6", "K7"):
        stacked = _fused_mats(label, D, F, V, gen, layers)
        per_layer = [[t[l] for pair in stacked for t in pair]
                     for l in range(layers)]
        routes = ({"wgmma": fm.fused_mlp_int4c,
                   "mma.sync": lambda x, *m: fm._launch_mlp(fm.LAYOUT_Q4C, x,
                                                            *m)}
                  if label == "K4" else _routes(label))
        for B in (rows if label != "K5" else sorted({8, *rows})):
            x = torch.randn((B, D), generator=gen, device="cuda").to(
                torch.bfloat16)
            for route, fn in routes.items():
                ms = graph_ms(lambda i: fn(x, *per_layer[i % layers]), layers)
                splits, moved = _route_bytes(label, route, B, per_layer[0],
                                             sms)
                # the products and merges, and the MLPs' output cast
                seq = _kernel_sequence(lambda: fn(x, *per_layer[0]), 6,
                                       len(moved) + (label != "K5"))
                out[(label, route, B)] = ms
                log(f"{label} {route} route, {B} rows (splits {splits}): "
                    f"{ms * 1e3:.1f} us a call by CUDA-graph replay")
                if seq is None:
                    log("  launches: the profiler saw no device kernel (not "
                        "measured)")
                    continue
                named = [(n, us) for n, us in seq
                         if any(k in n for k in ("fused_mlp", "swiglu",
                                                 "wo_kernel", "matmul_int4c"))]
                for (name, us), mb in zip(named, moved):
                    log(f"  {us:9.2f} us  {mb / 1e6:8.2f} MB  "
                        f"{mb / us / 1e3:7.1f} GB/s  {name[:70]}")
                for name, us in seq:
                    if (name, us) not in named:
                        log(f"  {us:9.2f} us  (other)  {name[:70]}")
        del stacked, per_layer
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------ the streaming core's probe
WO_COUNTERS = ("wait", "load", "decode", "mma", "flush", "release", "slots",
               "total", "sink", "sampled")
WO_MODES = ("run", "timed", "idle", "read", "decode")


def _wo_loop_sass(lib_path, layout, n):
    """The SASS of one slot's consumer loop of wo_kernel<layout, n, 0>: the
    smallest loop (a backward branch and its target) that holds HMMA, as
    (instructions, {opcode: count}); None without cuobjdump."""
    import re
    tool = _cuobjdump()
    if not tool:
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    want = re.compile(rf"wo_kernelILi{layout}ELi{n}ELi0E")
    lines, on = [], False
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            on = bool(want.search(m.group(1)))
            continue
        if on:
            lines.append(line)
    labels, addrs, instrs = {}, {}, []
    for line in lines:
        lab = re.match(r"\s*\.(L_x_\d+):", line)
        if lab:
            labels[lab.group(1)] = len(instrs)
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                       r"([A-Z0-9_.]+)(.*?);", line)
        if ins:
            addrs[int(ins.group(1), 16)] = len(instrs)
            instrs.append((ins.group(3), ins.group(4)))
    best = None
    for i, (op, rest) in enumerate(instrs):
        if not op.startswith("BRA"):
            continue
        m = re.search(r"\(\.(L_x_\d+)\)", rest)
        h = re.search(r"0x([0-9a-f]+)", rest)
        target = (labels.get(m.group(1)) if m else
                  addrs.get(int(h.group(1), 16)) if h else None)
        if target is not None and target <= i:
            body = instrs[target:i + 1]
            if any(o.startswith("HMMA") for o, _ in body) and (
                    best is None or len(body) < len(best)):
                best = body
    if best is None:
        return None
    ops = {}
    for op, _ in best:
        key = op.split(".")[0]
        ops[key] = ops.get(key, 0) + 1
    return len(best), dict(sorted(ops.items(), key=lambda kv: -kv[1]))


def phase_wo_probe(rows=(1, 20)):
    """The streaming core (K5's, K6's and K7's kernel) measured phase by
    phase (--phases wo_probe; in no default run; its library is built with
    -DWO_PROBE). For K5's head (K 4096, N 128256, q4c, groups of 128), one
    of K6's int8 products (K 4096, N 14336) and one of K7's q4p gate/up
    products (K 4096, N 14336, groups of 128) at 1 and 20 rows: the
    product as built (mode run) against the plain version; its time per
    call (CUDA-graph replay over 2 layers' weights) as built and with every
    warp timing the phases of each slot in registers (clock64, written once
    at exit: mode timed), which counts only within 10 % of the time as
    built; the cycles a slot per phase; the same for three cut-down
    consumers (idle: wait and release only; read: read every byte; decode:
    read and decode, no products); the SASS of one slot's consumer loop;
    and for K5 the same product on K4's wgmma kernel and on the mma.sync
    family, the A/B of the products' issue."""
    import ctypes
    from videollm_online_tpu_torch.ops import _build
    from videollm_online_tpu_torch.ops import fused_mlp as fm
    lib = _build.load("fused_mlp", ("WO_PROBE",))
    _build.build(["fused_mlp"])  # the library as built, whose SASS is read
    raw, _ = _ptxas_report_log(_build.build_log("fused_mlp", ("WO_PROBE",)))
    labels = _demangled(sorted(n for n in raw if "wo_kernel" in n))
    for mangled in sorted(labels, key=labels.get):
        log(f"  probe build {labels[mangled]}: {raw[mangled]}")
    probe = lib.wo_probe
    probe.restype = ctypes.c_int
    probe.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
                      + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    wgmma = lib.wo_probe_q4c_wgmma
    wgmma.restype = ctypes.c_int
    wgmma.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                      + [ctypes.c_void_p])
    gen = torch.Generator(device="cuda").manual_seed(6)
    sms = fm._sm_count(torch.device("cuda"))
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip()
    log(f"wo probe: SM clock (now, max) {clock}")
    out = {}
    for label, layout, K, n, group in (("K5", fm.LAYOUT_Q4C, 4096, 128256, 128),
                                       ("K6", fm.LAYOUT_Q8, 4096, 14336, 0),
                                       ("K7", fm.LAYOUT_Q4P, 4096, 14336, 128)):
        key = {fm.LAYOUT_Q4C: "q4c", fm.LAYOUT_Q4P: "q4p",
               fm.LAYOUT_Q8: "q8"}[layout]
        w, sc = _rand_quantized(key, K, n, gen, layers=2)
        group = group or K
        byte_rows, cbytes = w.shape[-2:]
        for B in rows:
            x = torch.randn((B, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            design, splits, per, grid = fm.wo_schedule(layout, byte_rows,
                                                       cbytes, B, group, 1,
                                                       sms)
            sass = _wo_loop_sass(_build.library_path("fused_mlp"), layout,
                                 design)
            log(f"{label} {B} rows: one slot's consumer loop of wo_kernel<"
                f"{layout}, {design}> (cuobjdump -sass): "
                + ("not measured" if sass is None else
                   f"{sass[0]} instructions, {sass[1]}"))
            part = torch.empty((splits * B * n,), dtype=torch.float32,
                               device="cuda")
            counters = torch.zeros((grid * 8 * len(WO_COUNTERS),),
                                   dtype=torch.int64, device="cuda")

            def run(mode, i):
                err = probe(mode, layout, design, x.data_ptr(), w[i].data_ptr(),
                            sc[i].data_ptr(), part.data_ptr(),
                            counters.data_ptr(), B, K, n, group, splits, per,
                            grid, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"wo_probe mode {mode}: CUDA error {err}")

            run(0, 0)
            got = part.view(splits, B, n).sum(0)
            if layout == fm.LAYOUT_Q4C:
                want = fm.matmul_int4c_reference(x, w[0], sc[0])
            elif layout == fm.LAYOUT_Q4P:
                want = fm._group_matmul(x, fm._q4p(w[0]), sc[0])
            else:
                want = x.float() @ w[0].float()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not err <= 1e-3 * float(want.abs().max()):
                raise AssertionError(f"{label} {B} rows: probe build run "
                                     f"differs from the plain version by {err}")
            bytes_ = w[0].numel() + (sc[0].numel() * 4 if layout != fm.LAYOUT_Q8
                                     else 0)
            # clocks up first; then run and timed in turns (run, timed,
            # timed, run), each mode's mean
            graph_ms(lambda i: run(0, i % 2), 2, reps=400)
            order = (0, 1, 1, 0, 2, 3, 4)
            took = [graph_ms(lambda i: run(mode, i % 2), 2, reps=40)
                    for mode in order]
            times = {name: float(np.mean([t for m, t in zip(order, took)
                                          if m == mode]))
                     for mode, name in enumerate(WO_MODES)}
            ratio = times["timed"] / times["run"]
            log(f"{label} {B} rows (N {design}, splits {splits}, per {per}, "
                f"grid {grid}; {bytes_ / 1e6:.1f} MB): ms a call: "
                + ", ".join(f"{k} {v:.4f} ({bytes_ / v / 1e6:.0f} GB/s)"
                            for k, v in times.items())
                + f"; timed / run {ratio:.3f}"
                + ("" if ratio <= 1.10 else
                   " -- the probe distorted the run: its readings are not used"))
            readings = {}
            for mode, name in enumerate(WO_MODES):
                if name == "run":
                    continue
                counters.zero_()
                run(mode, 0)
                c = counters.view(grid * 8, len(WO_COUNTERS)).cpu().double()
                slots, sampled = float(c[:, 6].sum()), float(c[:, 9].sum())
                per_slot = {k: float(c[:, i].sum()) / sampled
                            for i, k in enumerate(WO_COUNTERS[:6])}
                per_slot["sum"] = sum(per_slot.values())
                per_slot["total"] = float(c[:, 7].sum()) / slots
                readings[name] = per_slot
                mhz = float(c[:, 7].max()) / (times[name] * 1e3)
                log(f"  {name}: cycles a slot use a warp (a slot: 8 KB of "
                    f"one strip, shared by its group's warps; phases over "
                    f"the {sampled:.0f} uses timed of {slots:.0f}, total over "
                    f"all): " + ", ".join(f"{k} {v:.0f}"
                                          for k, v in per_slot.items())
                    + f"; busiest warp {c[:, 7].max():.0f} cycles = "
                    f"{mhz:.0f} MHz of the call's time")
            out[(label, B)] = {"ms": times, "ratio": ratio, "cycles": readings}
            if layout == fm.LAYOUT_Q4C:
                wout = torch.empty((B, n), dtype=torch.float32, device="cuda")
                _, s1, p1, g1 = fm.q4c_schedule(K, cbytes, B, 1, sms)
                wpart = torch.empty((s1 * B * n,), dtype=torch.float32,
                                    device="cuda")

                def run_wgmma(i):
                    e = wgmma(x.data_ptr(), w[i].data_ptr(), sc[i].data_ptr(),
                              wpart.data_ptr(), wout.data_ptr(), B, K, n,
                              group, s1, p1, g1,
                              torch.cuda.current_stream().cuda_stream)
                    if e:
                        raise RuntimeError(f"wo_probe_q4c_wgmma: CUDA error {e}")

                run_wgmma(0)
                torch.cuda.synchronize()
                werr = float((wout - want).abs().max())
                ms_w = graph_ms(lambda i: run_wgmma(i % 2), 2)
                ms_m = graph_ms(lambda i: fm._launch_matmul(x, w[i % 2],
                                                            sc[i % 2], False), 2)
                ms_s = graph_ms(lambda i: fm._launch_matmul(x, w[i % 2],
                                                            sc[i % 2], True), 2)
                log(f"  {label} {B} rows, ms a call with the merge: streaming "
                    f"core {ms_s:.4f}, K4's wgmma kernel {ms_w:.4f} (max error "
                    f"{werr:.2e}), mma.sync family {ms_m:.4f}")
        del w, sc
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 10
class _HeadTap:
    """Records the logits of every lm_head call while it is entered."""

    def __enter__(self):
        from videollm_online_tpu_torch.models import llama
        self.calls, self._llama, self._saved = [], llama, llama.lm_head

        def tapped(*a, **kw):
            logits = self._saved(*a, **kw)
            self.calls.append(logits.detach().float().clone())
            return logits

        llama.lm_head = tapped
        return self

    def __exit__(self, *exc):
        self._llama.lm_head = self._saved


# Two runs of one engine whose logits differ a little may part at a step
# whose two best logits lie closer than the runs' logits differ there (a tie
# flip). Such a step is accepted only if the runs' logits up to it differ by
# at most this share of the largest |logit| (kernel and plain version round
# x and h to bf16 at the same places, but an fp32 sum taken in another order
# can move one of those roundings by a bf16 ulp, 2^-9 of a value).
TIE_LOGIT_DIFF = 1e-2


def _explain_flip(a_calls, b_calls):
    """The first lm_head call at which two runs pick another token: raises
    unless it is a tie flip; returns its description."""
    for i, (la, lb) in enumerate(zip(a_calls, b_calls)):
        if la.shape != lb.shape:
            raise AssertionError(f"lm_head call {i}: shapes {la.shape} and "
                                 f"{lb.shape} differ before any token does")
        diff = float((la - lb).abs().max())
        scale = float(la.abs().max())
        if diff > TIE_LOGIT_DIFF * scale:
            raise AssertionError(f"lm_head call {i}: logits differ by {diff} "
                                 f"on a scale of {scale}")
        rows = (la.argmax(-1) != lb.argmax(-1)).flatten().nonzero().flatten()
        if len(rows) == 0:
            continue
        row = int(rows[0])
        top = la.reshape(-1, la.shape[-1])[row].topk(2)
        margin = float(top.values[0] - top.values[1])
        what = (f"lm_head call {i}, row {row}: tokens "
                f"{int(top.indices[0])} and {int(top.indices[1])} lie "
                f"{margin:.3g} apart, the two runs' logits differ by up to "
                f"{diff:.3g} there (largest |logit| {scale:.3g})")
        if margin > 2 * diff:
            raise AssertionError(f"not a tie flip: {what}")
        return what
    raise AssertionError("the transcripts differ but no lm_head call picks "
                         "another token")


def phase_small_int4_engine():
    """A small fp32 engine on mixed int4 weights, once through K4 and K5 and
    once through their plain versions: equal transcripts, or transcripts
    equal up to a step that is shown to be a tie flip."""
    from videollm_online_tpu_torch.core.config import (LiveConfig,
                                                       LlamaConfig)
    from videollm_online_tpu_torch.models import live, llama, quant
    from videollm_online_tpu_torch.ops import fused_mlp as fm
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
    params = quant.quantize_live_params(
        {"llama": llama.init_params(gen, cfg.llama, device="cuda"),
         "connector": live.init_connector(gen, cfg, device="cuda")}, bits=4)
    feats = np.random.RandomState(0).randn(
        24, cfg.frame_num_tokens, cfg.vision_hidden_size).astype(np.float32)
    kw = dict(kv_capacity=4096, spec_decode=True, device="cuda")
    _zero_launches()
    with _HeadTap() as tap_kernels:
        kernels = _drive(LiveInferEngine(params, tok, cfg, **kw), feats, 8, 8,
                         cfg.frame_fps)
    n = _read_launches()
    saved = fm.fused_mlp_int4c, fm.matmul_int4c
    fm.fused_mlp_int4c = fm.fused_mlp_int4c_reference
    fm.matmul_int4c = fm.matmul_int4c_reference
    try:
        with _HeadTap() as tap_plain:
            plain = _drive(LiveInferEngine(params, tok, cfg, **kw), feats, 8,
                           8, cfg.frame_fps)
    finally:
        fm.fused_mlp_int4c, fm.matmul_int4c = saved
    if not kernels or n["K4"] == 0 or n["K5"] == 0:
        raise AssertionError(f"launches {n}, responses {len(kernels)}")
    head = (f"small fp32 int4 engine (D 256, F 512, V 512) through K4 "
            f"({n['K4']} launches) and K5 ({n['K5']}) and through their "
            f"plain versions: ")
    if kernels == plain:
        log(head + f"{len(kernels)} responses, equal transcripts")
        return
    first = next((i for i, (a, b) in enumerate(zip(kernels, plain))
                  if a != b), min(len(kernels), len(plain)))
    flip = _explain_flip(tap_kernels.calls, tap_plain.calls)
    log(head + f"transcripts equal for the first {first} of {len(kernels)} "
        f"responses, then parted by a tie flip: {flip}")


# --------------------------------------------------------------- phase 11
def _count_forward(params, cfg, cache, attn_impl, S):
    """Launches of one S-token forward on the ring, which keeps its offset:
    logits at 8 gathered positions for S <= 128, at every position above
    (so that the head too sees more rows than the kernels take)."""
    from videollm_online_tpu_torch.models import llama
    emb = llama.embed_tokens(params["llama"],
                             torch.full((1, S), 33, dtype=torch.int32),
                             cfg.llama)
    _zero_launches()
    logits, _ = llama.forward(params["llama"], cfg=cfg.llama,
                              inputs_embeds=emb, kv_cache=cache,
                              attn_impl=attn_impl,
                              logit_gather_positions=(
                                  torch.arange(min(S, 8))[None]
                                  if S <= 128 else None))
    torch.cuda.synchronize()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"non-finite logits from a {S}-token forward")
    return _read_launches()


def phase_main_path_int4(n_frames: int = 64):
    """This slice's main path: serve/cli.py's build_engine with --model_size
    8b --quantize int4 --spec_decode (random weights from --seed, ring
    8192), the stream, queries and response length of the int8 main path."""
    from videollm_online_tpu_torch.models import generate as gen_mod
    from videollm_online_tpu_torch.models import llama, quant
    from videollm_online_tpu_torch.serve import cli
    query_every, resp_tokens = 8, 20
    args = cli.parse_args(["--video", "features", "--model_size", "8b",
                           "--quantize", "int4", "--spec_decode",
                           "--kv_capacity", "8192", "--seed", "0"])
    t0 = time.perf_counter()
    engine, cfg = cli.build_engine(args)
    torch.cuda.synchronize()
    params = engine.params
    log(f"8B int4 engine built by serve/cli.py on the card in "
        f"{time.perf_counter() - t0:.2f} s: parameters "
        f"{quant.param_bytes(params) / 2**30:.2f} GiB (MLP and lm_head "
        f"column-packed int4, attention and embedding int8), ring "
        f"{engine.kv_capacity}")
    # the int8 main path's gate and response length
    cfg = cfg.replace(frame_token_interval_threshold=0.725,
                      max_response_tokens=resp_tokens, gate_logit_bias=30.0)
    engine.cfg, engine.max_new = cfg, resp_tokens
    feats = np.random.RandomState(0).randn(
        n_frames, cfg.frame_num_tokens, cfg.vision_hidden_size
    ).astype(np.float32)
    _drive(engine, feats[:16], query_every, 8, cfg.frame_fps)   # warm-up
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    transcript = _drive(engine, feats, query_every, 8, cfg.frame_fps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _read_launches()
    steps, emitted = (int(x) for x in engine.spec_stats())
    log(f"int4 serving main path launches: {counts}")
    if not transcript or min(counts["K1"], counts["K4"], counts["K5"]) == 0:
        raise AssertionError(f"responses {len(transcript)}, launches "
                             f"{counts}")
    if not all(isinstance(r, str) and "Assistant:" in r
               for _, r in transcript):
        raise AssertionError(f"malformed responses: {transcript[:2]}")
    log(f"main path (8B int4, bf16 KV, capacity {engine.kv_capacity}, spec "
        f"decode): {n_frames} frames in {dt:.3f} s = {n_frames / dt:.3f} "
        f"frames/s, {len(transcript)} responses, final offset "
        f"{engine._host_offset}, spec {steps} verify steps -> {emitted} "
        f"tokens ({emitted / max(steps, 1):.3f} tokens/step)")
    log(f"first response: {transcript[0]!r}")
    _SINGLE_RANK["int4"] = transcript
    _SINGLE_RANK["int4_logits"] = _first_logits(params, cfg)

    cache = engine.cache
    L = cfg.llama.num_layers
    base = int(cache.offset[0])
    for S, want_k4, want_k5 in ((1, L, 1), (20, L, 1), (91, L, 1),
                                (128, L, 1), (129, 0, 0)):
        n = _count_forward(params, cfg, cache, engine.attn_impl, S)
        if (n["K4"], n["K5"]) != (want_k4, want_k5):
            raise AssertionError(f"{S}-token forward: launches {n}, want K4 "
                                 f"{want_k4}, K5 {want_k5}")
        log(f"  {S}-token forward: K1 {n['K1']}, K4 {n['K4']}, K5 {n['K5']} "
            f"launches" + (" (the dequantizing route)" if not want_k4 else ""))
    assert int(cache.offset[0]) == base

    prompt_ids = torch.tensor([[33, 34, 35]])
    prompt = llama.embed_tokens(params["llama"], prompt_ids, cfg.llama)
    for mode in ("greedy", "spec"):
        torch.cuda.synchronize()
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
        log(f"{mode} decode (8B int4, offset {int(cache.offset[0])}): "
            f"{n_tok} tokens in {forwards} forwards, "
            f"{(time.perf_counter() - t0) * 1e3 / n_tok:.3f} ms/token")
    for S in (1, engine.spec_draft + 1):
        _profile_forward(params, cfg, cache, engine.attn_impl, S, "8B int4")
    del engine, cache, params
    torch.cuda.empty_cache()

    # the command a user types, end to end (parameters built again), with
    # the main path's response length
    import os
    out_dir = _out_dir("cli_int4")
    video = os.path.join(out_dir, "features.npy")
    np.save(video, feats[:8])
    history = os.path.join(out_dir, "history.json")
    with _cli_config(max_response_tokens=resp_tokens):
        cli.main(["--video", video, "--model_size", "8b", "--quantize",
                  "int4", "--spec_decode", "--kv_capacity", "8192",
                  "--num_ticks", "8", "--output", history])
    with open(history) as f:
        h = json.load(f)
    fps = h["average_processing_fps"]
    if not fps > 0:
        raise AssertionError(f"the CLI reported {fps} frames/s")
    # phase 15b holds serve/cli.py --pipelined to this dialogue
    _SINGLE_RANK["int4_cli"] = [(m["role"], m["content"])
                                for m in h["messages"]]
    torch.cuda.empty_cache()
    return {"launches": counts, "frames_per_s": n_frames / dt}


# --------------------------------------------------------------- phase 12
def _forward_ms(params, cfg, cache, attn_impl, S):
    """Device ms of one S-token forward with the head on its last row
    (CUDA events, 2 warm-ups, 5 calls; the host's launch cost is inside it
    where it exceeds the device's work)."""
    from videollm_online_tpu_torch.models import llama
    emb = llama.embed_tokens(params["llama"],
                             torch.full((1, S), 33, dtype=torch.int32),
                             cfg.llama)
    return cuda_ms(lambda _: llama.forward(
        params["llama"], cfg=cfg.llama, inputs_embeds=emb, kv_cache=cache,
        attn_impl=attn_impl, last_logit_only=True), 5, 2)


def phase_ab_paths(n_layers: int = 8, n_frames: int = 16):
    """K6 and K7 through the engine, at the 8B widths and a depth of 8
    layers. No quantizer emits row-packed q4p layers and the dispatch sends
    int8 layers to the dequantizing matmuls, so neither kernel is on a
    serving main path; these are the runs they exist for. K7: an engine
    whose MLP matrices are q4p, which ``maybe_fused`` sends to K7, whose
    wrapper takes the streaming core at these shapes (asserted). K6: the
    A/B of the int8 engine, its MLP routed to K6 by a dispatch that this
    script puts in place of ``maybe_fused`` for the run. Each engine serves
    a short stream; then a 1-token and a 20-token forward are timed through
    the kernel and through the dequantizing route (``VLO_FUSED_MLP=0``)."""
    import dataclasses
    import os

    from videollm_online_tpu_torch.core.config import LiveConfig, LlamaConfig
    from videollm_online_tpu_torch.models import live, quant
    from videollm_online_tpu_torch.ops import fused_mlp as fm
    from videollm_online_tpu_torch.serve.engine import LiveInferEngine
    from videollm_online_tpu_torch.tokenizer.live_tokenizer import (
        LiveTokenizer)
    from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer
    lcfg = dataclasses.replace(LlamaConfig(dtype="bfloat16"),
                               num_layers=n_layers)
    cfg = LiveConfig(llama=lcfg, lora=None)
    tok = LiveTokenizer(ByteTokenizer(), cfg)
    cfg = tok.cfg.replace(frame_token_interval_threshold=0.725,
                          max_response_tokens=20, gate_logit_bias=30.0)
    gen = torch.Generator(device="cuda").manual_seed(5)
    feats = np.random.RandomState(0).randn(
        n_frames, cfg.frame_num_tokens, cfg.vision_hidden_size
    ).astype(np.float32)
    D, F = lcfg.hidden_size, lcfg.intermediate_size

    def int8_to_k6(x, lp, ll):
        mats = [lp.get(n) for n in ("w_gate", "w_up", "w_down")]
        if (x.shape[0] * x.shape[1] <= fm.MAX_FUSED_TOKENS and ll is None
                and all(isinstance(m, dict) and "q8" in m for m in mats)):
            return fm.mlp_int8(x, lp)
        return None

    out = {}
    for label, key in (("K6", "q8"), ("K7", "q4p")):
        llama_params = quant.random_quantized_llama_params(
            gen, lcfg, bits=8, device="cuda")
        if key == "q4p":
            for name, (k, n) in (("w_gate", (D, F)), ("w_up", (D, F)),
                                 ("w_down", (F, D))):
                w, sc = _rand_quantized("q4p", k, n, gen, n_layers)
                llama_params["layers"][name] = {"q4p": w, "scale": sc}
            layer = [(llama_params["layers"][m]["q4p"][i],
                      llama_params["layers"][m]["scale"][i])
                     for m in ("w_gate", "w_up", "w_down")
                     for i in range(n_layers)]
            if not fm._wo_takes(fm.LAYOUT_Q4P, layer):
                raise AssertionError("K7's layers do not take the streaming "
                                     "core")
        params = {"llama": llama_params,
                  "connector": live.init_connector(gen, cfg, device="cuda")}
        engine = LiveInferEngine(params, tok, cfg, kv_capacity=4096,
                                 spec_decode=True, device="cuda")
        saved = fm.maybe_fused
        if label == "K6":
            fm.maybe_fused = int8_to_k6
        try:
            _zero_launches()
            transcript = _drive(engine, feats, 8, 8, cfg.frame_fps)
            torch.cuda.synchronize()
            counts = _read_launches()
            kernel_ms = {S: _forward_ms(params, cfg, engine.cache,
                                        engine.attn_impl, S) for S in (1, 20)}
        finally:
            fm.maybe_fused = saved
        os.environ["VLO_FUSED_MLP"] = "0"
        try:
            route_ms = {S: _forward_ms(params, cfg, engine.cache,
                                       engine.attn_impl, S) for S in (1, 20)}
        finally:
            del os.environ["VLO_FUSED_MLP"]
        if not transcript or counts[label] == 0:
            raise AssertionError(f"{label} path: responses "
                                 f"{len(transcript)}, launches {counts}")
        log(f"{label} through the engine (8B widths, {n_layers} layers, "
            f"{key} MLP on the streaming core, {n_frames} frames): "
            f"{len(transcript)} responses, "
            f"launches {counts}; one forward through {label} / through the "
            f"dequantizing route, ms: 1 token {kernel_ms[1]:.3f} / "
            f"{route_ms[1]:.3f}, 20 tokens {kernel_ms[20]:.3f} / "
            f"{route_ms[20]:.3f}")
        out[label] = counts[label]
        del engine, params, llama_params
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 13
# K3 against its plain version (_close's readings). The plain version is the
# JAX package's gather reference, all fp32; the kernel rounds the
# probabilities to q's dtype before P.V, as the TPU kernel does, which moves
# a bf16 output by about an ulp. The bounds sit above the readings over this
# phase's cases: bf16 outputs need an atol up to 2.9e-3 at rtol 2e-2 (the
# small cases, whose outputs are larger; the 8B cases 8.4e-4) and read a
# relative norm error up to 3.0e-3; fp32 needs 3.0e-7 and reads 2.8e-7.
K3_TOL = {torch.bfloat16: {"atol": 4e-3, "rtol": 2e-2, "rel": 5e-3},
          torch.float32: {"atol": 1e-6, "rtol": 1e-5, "rel": 1e-6}}
K3_MAIN = dict(B=8, Hq=32, Hkv=8, d=128, page=512, maxp=5, P=41)
# per stream of the 8B case: the query's first slot (S up to 128 stays in
# the stream's five pages; several cross a page boundary)
K3_OFFSETS = (0, 100, 448, 511, 1000, 1530, 2000, 2431)


def _k3_pools(L, P, Hkv, page, d, kind, gen):
    """Random pools: bf16 or fp32 values, or int8 codes with fp32 scales."""
    shape = (L, P, Hkv, page, d)
    if kind == "int8":
        pk, pv = (torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(shape[:-1], generator=gen, device="cuda") / 64
                  for _ in range(2))
        return pk, pv, ks, vs
    pk, pv = (torch.randn(shape, generator=gen, device="cuda").to(kind)
              for _ in range(2))
    return pk, pv, None, None


def _k3_table(B, maxp, P, seed, trash_row):
    """Each stream's pages drawn from pool pages 1..P-1 in a shuffled order;
    ``trash_row``'s last entry is the trash page 0 (an unmapped lookahead)."""
    perm = np.random.RandomState(seed).permutation(P - 1) + 1
    table = perm[:B * maxp].reshape(B, maxp).astype(np.int32)
    table[trash_row, -1] = 0
    return torch.from_numpy(table).cuda()


def _k3_poison(pools, layer, table, first_slot, last_slot, value):
    """Writes ``value`` over what no query of the case may read: the trash
    page, and every slot of each stream past its last visible slot or below
    its first (a window's lower edge)."""
    page = pools[0].shape[3]
    for pool in pools:
        if pool is None:
            continue
        v = value if pool.dtype.is_floating_point else 0
        pool[layer, 0] = v
        for b, (first, last) in enumerate(zip(first_slot, last_slot)):
            for j, phys in enumerate(table[b].tolist()):
                if not phys:
                    continue
                lo = max(last + 1 - j * page, 0)
                if lo < page:
                    pool[layer, phys, :, lo:] = v
                hi = min(first - j * page, page)
                if hi > 0:
                    pool[layer, phys, :, :hi] = v


def _k3_case(label, pools, table, q_pos, layer, *, window=None, Hq,
             dtype, gen):
    """K3 against the plain version on one input (_repeatable: split and
    not, each twice with equal bits); the plain version reads
    the pools as they are, the kernel reads them with NaN written over the
    trash page, past each stream's last visible slot and below its first
    (which it must never read), and they are restored to 0 after."""
    from videollm_online_tpu_torch.ops import decode_attention as da
    from videollm_online_tpu_torch.ops import paged_attention as pa
    pk, pv, ks, vs = pools
    B, S = q_pos.shape
    q = torch.randn((B, Hq, S, pk.shape[-1]), generator=gen,
                    device="cuda").to(dtype)
    want = pa.paged_attention_reference(q, pk, pv, table, q_pos, layer,
                                        window=window, k_scale=ks,
                                        v_scale=vs)
    last = q_pos.max(dim=1).values.tolist()
    first = ((q_pos.min(dim=1).values - window + 1).clamp(min=0).tolist()
             if window else [0] * B)
    _k3_poison(pools, layer, table, first, last, float("nan"))
    try:
        return _repeatable(f"K3 {label}", lambda: pa.paged_decode_attention(
            q, pk, pv, table, q_pos, layer, window=window, k_scale=ks,
            v_scale=vs), want, K3_TOL[dtype], da)
    finally:
        _k3_poison(pools, layer, table, first, last, 0.0)


def _k3_qpos(offsets, S):
    return (torch.tensor(offsets, dtype=torch.int32)[:, None]
            + torch.arange(S, dtype=torch.int32)[None]).cuda()


def _k3_timing(pools, table, q_pos, Hq, gen):
    """K3, the plain version, the gathering route (index_select of the
    table's pages, int8 codes times their scales, then
    scaled_dot_product_attention over the gathered slots, the nearest
    library yardstick, never called by the port) and K1 on a ring holding
    the same K/V (S <= 64), each call on the next layer so that the K/V come
    from device memory; with the bound from the visible slots of this
    input. Int8 pools take bf16 queries."""
    from videollm_online_tpu_torch.ops import decode_attention as da
    from videollm_online_tpu_torch.ops import paged_attention as pa
    pk, pv, ks, vs = pools
    sc = {} if ks is None else {"k_scale": ks, "v_scale": vs}
    L, P, Hkv, page, d = pk.shape
    B, S = q_pos.shape
    maxp = table.shape[1]
    qdt = torch.bfloat16 if ks is not None else pk.dtype
    q = torch.randn((B, Hq, S, d), generator=gen, device="cuda").to(qdt)
    slots = maxp * page
    mask = (torch.arange(slots, device="cuda")[None, None]
            <= q_pos[:, :, None])[:, None]                  # (B, 1, S, slots)
    flat = table.reshape(-1).long()

    def gathered(pool, l):     # (P, Hkv, page[, d]) -> (B, Hkv, slots[, d])
        tail = pool.shape[4:]
        g = pool[l].index_select(0, flat).reshape((B, maxp, Hkv, page) + tail)
        return g.transpose(1, 2).reshape((B, Hkv, slots) + tail)

    def kern(i):
        return pa.paged_decode_attention(q, pk, pv, table, q_pos, i % L, **sc)

    def plain(i):
        return pa.paged_attention_reference(q, pk, pv, table, q_pos, i % L,
                                            **sc)

    def route(i):
        k, v = gathered(pk, i % L), gathered(pv, i % L)
        if ks is not None:
            k = (k.float() * gathered(ks, i % L)[..., None]).to(qdt)
            v = (v.float() * gathered(vs, i % L)[..., None]).to(qdt)
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)

    t = {"ms": graph_ms(kern, L), "plain_ms": cuda_ms(plain, 3, 1),
         "library_ms": graph_ms(route, L), "eager_ms": cuda_ms(kern, 4 * L)}
    t["schedule"] = _schedule(da, da.kernel_design(qdt, d), B, Hkv,
                              Hq // Hkv * S, maxp * page)
    if S <= da.MAX_CHUNK:
        ring = {n: torch.stack([gathered(x, l) for l in range(L)])
                for n, x in (("k", pk), ("v", pv), *sc.items())}
        rsc = {n: ring[n] for n in sc}
        t["k1_ms"] = graph_ms(lambda i: da.ring_decode_attention_layered(
            q, ring["k"], ring["v"], q_pos, i % L, **rsc), L)
        del ring, rsc
    visible = int((q_pos.max(dim=1).values + 1).sum())
    rows_slots = int((q_pos.long() + 1).sum()) * (Hq // Hkv)
    elt = pk.element_size() + (4 / d if ks is not None else 0)
    bytes_ = (2 * visible * Hkv * d * elt + 2 * q.numel() * q.element_size()
              + q_pos.numel() * 4 + table.numel() * 4)
    flops = 4 * d * Hkv * rows_slots
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return {**t, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "mbytes": bytes_ / 1e6}


def phase_k3():
    from videollm_online_tpu_torch.ops import paged_attention as pa
    gen = torch.Generator(device="cuda").manual_seed(13)
    m = K3_MAIN
    readings = {}

    def note(cls, r):
        readings.setdefault(cls, []).append(r)

    table = _k3_table(m["B"], m["maxp"], m["P"], 0, trash_row=0)
    timing = {}
    for kind in (torch.bfloat16, "int8"):
        L = 32
        pools = _k3_pools(L, m["P"], m["Hkv"], m["page"], m["d"], kind, gen)
        for S in (1, 7, 20, 21, 91, 128):
            q_pos = _k3_qpos(K3_OFFSETS, S)
            for window in (None, 700):
                for layer in (0, L - 1):
                    name = f"{'bf16' if kind != 'int8' else 'int8'}" + (
                        " window" if window else "")
                    note(name, _k3_case(
                        f"8B {name} S {S} layer {layer}", pools, table,
                        q_pos, layer, window=window, Hq=m["Hq"],
                        dtype=torch.bfloat16, gen=gen))
        for S in ((1, 20, 91, 128) if kind == torch.bfloat16 else (20,)):
            timing[("bf16" if kind == torch.bfloat16 else "int8", S)] = \
                _k3_timing(pools, table, _k3_qpos(K3_OFFSETS, S), m["Hq"],
                           gen)
        del pools
        torch.cuda.empty_cache()
    # small odd cases: head sizes, pages below and at the tile, fp32, B 1/3
    for label, (B, Hq, Hkv, d, page, maxp, kind, offsets, S, window) in {
            "d64 page32 bf16 B3": (3, 8, 2, 64, 32, 6, torch.bfloat16,
                                   (0, 40, 150), 7, None),
            "d256 page64 bf16 B1": (1, 8, 2, 256, 64, 4, torch.bfloat16,
                                    (170,), 20, None),
            "d64 page64 fp32 B3 window": (3, 8, 2, 64, 64, 6, torch.float32,
                                          (5, 63, 250), 33, 40),
            "d128 page32 fp32 B1": (1, 4, 4, 128, 32, 8, torch.float32,
                                    (100,), 91, None),
            "d256 page32 int8 B3": (3, 4, 1, 256, 32, 4, "int8",
                                    (0, 31, 90), 5, None),
            "d64 page64 int8 B1 fp32": (1, 8, 2, 64, 64, 3, "int8",
                                        (60,), 64, 30),
            "d128 page32 bf16 B3 window": (3, 8, 2, 128, 32, 8,
                                           torch.bfloat16, (0, 90, 170),
                                           21, 50),
            "d64 page32 int8 B2 window": (2, 4, 1, 64, 32, 6, "int8",
                                          (33, 100), 7, 40),
            "d128 page128 int8 B3": (3, 8, 2, 128, 128, 3, "int8",
                                     (250, 129, 0), 91, None)}.items():
        P = 1 + B * maxp
        pools = _k3_pools(2, P, Hkv, page, d, kind, gen)
        tab = _k3_table(B, maxp, P, B + d + page, trash_row=B - 1)
        qdt = torch.float32 if ("fp32" in label) else torch.bfloat16
        note("small fp32" if qdt == torch.float32 else "small bf16",
             _k3_case(label, pools, tab, _k3_qpos(offsets, S), 1,
                      window=window, Hq=Hq, dtype=qdt, gen=gen))
    log(f"K3 vs plain: {sum(len(r) for r in readings.values())} cases agree "
        f"(tolerance bf16 {K3_TOL[torch.bfloat16]}, fp32 "
        f"{K3_TOL[torch.float32]}); worst reading per class:")
    for name, rs in readings.items():
        log(f"  {name}: {_readings(_worst(rs))}")
    for (kv, S), t in timing.items():
        k1 = (f"K1 on an equal ring {t['k1_ms']:.5f} ms" if "k1_ms" in t
              else f"K1 takes S <= 64 only")
        log(f"K3 at 8B shapes (B 8, Hq 32, Hkv 8, d 128, page 512, {kv} "
            f"K/V, bf16 q), S={S}, device ms per call from CUDA-graph replay over 32 "
            f"layers: kernel {t['ms']:.5f} (slices, row blocks, splits "
            f"{t['schedule']}), plain {t['plain_ms']:.5f}, "
            f"gathering route {t['library_ms']:.5f}, {k1}, bound "
            f"{t['bound_ms']:.5f} ({t['bound_by']}, {t['mbytes']:.1f} MB at "
            f"{HBM_BYTES_PER_S / 1e12} TB/s): {t['ms'] / t['bound_ms']:.2f} x "
            f"the bound; eager kernel call from Python {t['eager_ms']:.5f}")
    assert pa.paged_decode_attention.launches > 0
    errs = max(_worst(rs)["max"] for rs in readings.values())
    return {"max_abs_err": errs, **timing[("bf16", 1)], "timing": timing}


def phase_tc_configs():
    """The tensor-core design's configurations A/B at the main paths'
    shapes (--phases tc_configs; in no default run). Each configuration
    (slices of each K/V tile per row block, ops/decode_attention.py
    TC_ROWS_PER_CTA: 1 = two wgmma warpgroups of 64 rows, more = 4
    mma.sync warps sharing fewer rows) runs on the same input, with the
    splits the wrapper sizes for it, held to the plain version at
    K1_TOL / K3_TOL and timed by CUDA-graph replay over 32 layers; '*'
    marks the wrapper's own choice. K1 on the 8B ring at offset 3000, K3
    on phase 13's 8-stream pool of 512-slot pages, bf16."""
    from videollm_online_tpu_torch.ops import decode_attention as da
    from videollm_online_tpu_torch.ops import paged_attention as pa
    gen = torch.Generator(device="cuda").manual_seed(21)
    own = da.row_blocks

    def forced(slices):
        per = da.TC_ROWS_PER_CTA[slices]
        return lambda design, rows: (
            (slices, per, -(-rows // per)) if design == "tensor cores"
            else own(design, rows))

    def compare(label, B, Hkv, slots, rows, want, call, tol):
        chosen = own("tensor cores", rows)[0]
        out = []
        try:
            for slices in da.TC_ROWS_PER_CTA:
                da.row_blocks = forced(slices)
                _close(f"{label} slices {slices}", call(0), want, tol)
                nsplit = _schedule(da, "tensor cores", B, Hkv, rows, slots)[2]
                out.append(f"{slices}{'*' if slices == chosen else ''}: "
                           f"{graph_ms(call, 32):.5f} ms ({nsplit} splits)")
        finally:
            da.row_blocks = own
        log(f"  {label}, {rows} rows a kv head: " + ", ".join(out))

    L, Hq, Hkv, C, d = 32, 32, 8, 16384, 128
    k_all, v_all = (torch.randn((L, 1, Hkv, C, d), generator=gen,
                                device="cuda").to(torch.bfloat16)
                    for _ in range(2))
    log("tensor-core configurations by slices (ms per call):")
    for S in (1, 4, 5, 7, 8, 20, 64):
        q = torch.randn((1, Hq, S, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        q_pos = (3000 + torch.arange(S, device="cuda",
                                     dtype=torch.int32))[None]
        compare(f"K1 S {S}", 1, Hkv, C, Hq // Hkv * S,
                da.ring_decode_attention_layered_reference(
                    q, k_all, v_all, q_pos, 0),
                lambda i: da.ring_decode_attention_layered(
                    q, k_all, v_all, q_pos, i % L), K1_TOL[torch.bfloat16])
    del k_all, v_all
    m = K3_MAIN
    pk, pv, _, _ = _k3_pools(L, m["P"], m["Hkv"], m["page"], m["d"],
                             torch.bfloat16, gen)
    table = _k3_table(m["B"], m["maxp"], m["P"], 0, trash_row=0)
    for S in (1, 4, 7, 20, 91, 128):
        q = torch.randn((m["B"], m["Hq"], S, m["d"]), generator=gen,
                        device="cuda").to(torch.bfloat16)
        q_pos = _k3_qpos(K3_OFFSETS, S)
        compare(f"K3 S {S}", m["B"], m["Hkv"], m["maxp"] * m["page"],
                m["Hq"] // m["Hkv"] * S,
                pa.paged_attention_reference(q, pk, pv, table, q_pos, 0),
                lambda i: pa.paged_decode_attention(q, pk, pv, table, q_pos,
                                                    i % L),
                K3_TOL[torch.bfloat16])


# --------------------------------------------------------------- phase 14
def _ms_admit(ms, i, feats, query_every, query="What am I doing?"):
    """benchmarks/serve_bench.py's admission: a stream's whole clip at
    t = 0 and a query every ``query_every`` frames."""
    ms.input_frames(i, 0.0, feats)
    for qt in range(0, len(feats), query_every):
        ms.input_query(i, query, qt / ms.frame_fps)


def _ms_drain(ms, max_ticks=4096):
    """Ticks until nothing is pending; returns (results per stream, ticks)."""
    out = [[] for _ in range(ms.N)]
    ticks = 0
    while ms.pending() and ticks < max_ticks:
        for i, r in enumerate(ms.step()):
            if r is not None:
                out[i].append(r)
        ticks += 1
    if ms.pending():
        raise AssertionError(f"multistream engine did not drain in {ticks} "
                             f"ticks")
    return out, ticks


def phase_small_multistream():
    """A small fp32 MultiStreamEngine (the shape of phase 4, 3 streams,
    pages of 64) through K3 and through its plain version: equal
    transcripts, or equal up to a step shown to be a tie flip; its
    per-stream transcripts equal three single-stream engines' (the ring
    and K1); stats() holds after a close_stream, a re-admission through
    the prefix cache and a fork_stream."""
    from videollm_online_tpu_torch.core.config import (LiveConfig,
                                                       LlamaConfig)
    from videollm_online_tpu_torch.models import live, llama
    from videollm_online_tpu_torch.ops import paged_attention as pa
    from videollm_online_tpu_torch.serve.engine import LiveInferEngine
    from videollm_online_tpu_torch.serve.multistream import MultiStreamEngine
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
    rng = np.random.RandomState(0)
    feats = [rng.randn(24, cfg.frame_num_tokens,
                       cfg.vision_hidden_size).astype(np.float32)
             for _ in range(3)]
    kw = dict(num_streams=3, kv_capacity=2048, paged=True, page_size=64,
              spec_decode=True, device="cuda")

    def run():
        ms = MultiStreamEngine(params, tok, cfg, **kw)
        for i in range(3):
            _ms_admit(ms, i, feats[i], 8)
        out, ticks = _ms_drain(ms)
        return ms, out, ticks

    _zero_launches()
    with _HeadTap() as tap_kernel:
        ms, kernel, ticks = run()
    n = _read_launches()
    saved = pa.paged_attention
    pa.paged_attention = pa.paged_attention_reference
    try:
        with _HeadTap() as tap_plain:
            _, plain, _ = run()
    finally:
        pa.paged_attention = saved
    if n["K3"] == 0 or n["K1"] or not any(kernel):
        raise AssertionError(f"launches {n}, responses {kernel}")
    head = (f"small fp32 multistream engine (3 streams, pages of 64, spec "
            f"decode; K3 {n['K3']} launches): {sum(map(len, kernel))} "
            f"responses in {ticks} ticks, ")
    if kernel == plain:
        log(head + "equal transcripts through K3 and the plain version")
    else:
        log(head + "through K3 and the plain version parted by a tie flip: "
            + _explain_flip(tap_kernel.calls, tap_plain.calls))
    singles = []
    for i in range(3):
        eng = LiveInferEngine(params, tok, cfg, kv_capacity=4096,
                              spec_decode=True, device="cuda")
        eng.load_video(feats[i])
        for qt in range(0, 24, 8):
            eng.input_query_stream("What am I doing?", qt / cfg.frame_fps)
        eng.input_video_stream(23 / cfg.frame_fps)
        got = []
        while True:
            q, r = eng()
            if r is None:
                break
            got.append((q, r))
        singles.append(got)
    if [list(t) for t in ms.transcripts] != singles:
        raise AssertionError(f"multistream transcripts differ from the "
                             f"single-stream engines':\n{ms.transcripts}\n"
                             f"{singles}")
    log("  per-stream transcripts equal three single-stream engines' (the "
        "ring, K1)")
    # close, re-admit through the prefix cache, fork; stats() asserts the
    # page allocator's conservation invariants each time
    ms.close_stream(0)
    ms.stats()
    _ms_admit(ms, 0, feats[0][:8], 8)
    _ms_drain(ms)
    ms.close_stream(2)
    ms.fork_stream(0, 2)
    pool = ms.stats()["pool"]
    if pool["prefix_hits"] < 1 or ms.transcripts[2] != ms.transcripts[0]:
        raise AssertionError(f"prefix admission or fork failed: {pool}")
    _ms_admit(ms, 2, feats[2][:4], 8, "And now?")
    _ms_drain(ms)
    log(f"  after a close, a re-admission through the prefix cache and a "
        f"fork: stats() holds, pool {ms.stats()['pool']}")


# --------------------------------------------------------------- phase 15
class _CountForwards:
    """Counts the decoder module's forward calls (``models/llama.py``'s
    unless another is given; one per batched forward) while entered, as
    the kernels' launch counters see them: a decode forward replayed as a
    CUDA graph (``DecodeGraph``) launches nothing through them and counts
    0, the one that captured it (a warm-up, then the capture) 2."""

    def __init__(self, module=None):
        self._module = module

    def __enter__(self):
        from videollm_online_tpu_torch.models import llama
        self._llama = self._module or llama
        self.n, self._saved = 0, self._llama.forward

        def counted(*a, **kw):
            g = kw.get("decode_graph")
            before = (g.captures, g.replays) if g is not None else (0, 0)
            out = self._saved(*a, **kw)
            after = (g.captures, g.replays) if g is not None else (0, 0)
            self.n += 1 + (after[0] - before[0]) - (after[1] - before[1])
            return out

        self._llama.forward = counted
        return self

    def __exit__(self, *exc):
        self._llama.forward = self._saved


def _ms_run(ms, feats, query_every):
    """benchmarks/serve_bench.py's run: reset, every stream admitted at
    t = 0, ticks until drained. Returns (seconds, responses, ticks,
    forwards, launches)."""
    ms.reset()
    torch.cuda.synchronize()
    _zero_launches()
    with _CountForwards() as fc:
        t0 = time.perf_counter()
        for i in range(ms.N):
            _ms_admit(ms, i, feats, query_every)
        out, ticks = _ms_drain(ms)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    return dt, out, ticks, fc.n, _read_launches()


def _ms_cache_bytes(cache):
    pools = [cache.k, cache.v] + ([cache.k_scale, cache.v_scale]
                                  if cache.quantized else [])
    return sum(p.numel() * p.element_size() for p in pools)


def phase_main_path_multistream(n_streams: int = 8, n_frames: int = 64):
    """This slice's main path: the 8B int8-weight MultiStreamEngine at full
    width and depth with benchmarks/serve_bench.py's traffic (8 streams, 64
    frames each admitted at t = 0, a query every 8 frames, gate bias 30,
    20-token responses, kv_capacity sized as that script sizes it, so the
    paged pool of 5 pages of 512 a stream; the prefix cache on); then the
    same traffic with kv_quant int8 and spec decode, and on the batched
    ring (paged=False); then one close, admit and fork turn."""
    from videollm_online_tpu_torch.core.config import (LiveConfig,
                                                       LlamaConfig)
    from videollm_online_tpu_torch.models import live, quant
    from videollm_online_tpu_torch.serve.multistream import MultiStreamEngine
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
    fnt = cfg.frame_num_tokens
    capacity = 256 * ((n_frames * (fnt + 4) + 128 + (n_frames // 8 + 2)
                       * (128 + 20)) // 256 + 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = {"llama": quant.random_quantized_llama_params(
                  gen, cfg.llama, bits=8, device="cuda"),
              "connector": live.init_connector(gen, cfg, device="cuda")}
    feats = np.random.RandomState(7).randn(
        n_frames, fnt, cfg.vision_hidden_size).astype(np.float32)
    L = lcfg.num_layers
    frames = n_streams * n_frames
    results = {}
    for name, kw in (("paged, bf16 KV", {}),
                     ("paged, int8 KV, spec decode",
                      dict(kv_quant="int8", spec_decode=True)),
                     ("ring, bf16 KV", dict(paged=False))):
        ms = MultiStreamEngine(params, tok, cfg, num_streams=n_streams,
                               kv_capacity=capacity, device="cuda", **kw)
        _ms_run(ms, feats[:16], query_every)                    # warm-up
        dt, out, ticks, fwds, n = _ms_run(ms, feats, query_every)
        st = ms.stats()
        resp = st["response_latency"].get("response", {})
        n_resp = sum(map(len, out))
        if n_resp < n_streams * (n_frames // query_every) or not all(
                "Assistant:" in r for o in out for _, r in o):
            raise AssertionError(f"{name}: responses {out}")
        if ms.paged and (n["K3"] != L * fwds or n["K1"]):
            raise AssertionError(f"{name}: K3 {n['K3']} launches over {fwds} "
                                 f"forwards (want {L} a forward), K1 {n['K1']}")
        if not ms.paged and (n["K3"] or not n["K1"]):
            raise AssertionError(f"{name}: launches {n}")
        spec = ""
        if ms.spec_decode:
            steps, emitted = (int(x) for x in ms.spec_stats())
            spec = (f", spec {steps} verify steps -> {emitted} tokens "
                    f"({emitted / max(steps, 1):.3f} tokens/step)")
        log(f"multistream main path ({name}, 8B int8 weights, {n_streams} "
            f"streams x {n_frames} frames, kv_capacity {capacity}"
            + (f", pool {ms.pool_pages} pages of {ms.page_size}"
               if ms.paged else "") + f"): {frames} frames in {dt:.3f} s = "
            f"{frames / dt:.3f} frames/s aggregate "
            f"({frames / dt / n_streams:.3f} a stream), {n_resp} responses, "
            f"{ticks} ticks, {fwds} forwards, launches {n}{spec}")
        log(f"  response latency p50 {resp.get('p50_ms', 0):.1f} ms, p99 "
            f"{resp.get('p99_ms', 0):.1f} ms ({resp.get('count', 0)} "
            f"responses); tick p50 {st['ticks'].get('p50_ms', 0):.1f} ms, "
            f"p99 {st['ticks'].get('p99_ms', 0):.1f} ms; KV "
            f"{_ms_cache_bytes(ms.cache) / 2**30:.2f} GiB, parameters "
            f"{quant.param_bytes(params) / 2**30:.2f} GiB; offsets "
            f"{[s['offset'] for s in st['streams']]}"
            + (f"; pool {st['pool']}" if ms.paged else ""))
        results[name] = {"frames_per_s": frames / dt, "launches": n,
                         "forwards": fwds, "ticks": ticks}
        if name == "paged, bf16 KV":
            log(f"  first response: {out[0][0]!r}")
            for S in (1, 20, 91, 128):
                _profile_forward(params, cfg, ms.cache, ms.attn_impl, S,
                                 "8B int8, 8 streams, paged")
            # one close, admit and fork turn, then stats()
            ms.close_stream(0)
            _ms_admit(ms, 0, feats[:16], query_every)
            _ms_drain(ms)
            ms.close_stream(1)
            ms.fork_stream(0, 1)
            pool = ms.stats()["pool"]
            if pool["prefix_hits"] < 1:
                raise AssertionError(f"no prefix-cache admission: {pool}")
            log(f"  after a close, a re-admission (prefix cache) and a fork: "
                f"pool {pool}")
        del ms
        torch.cuda.empty_cache()
    return results


# -------------------------------------------------------------- phase 15b
@contextlib.contextmanager
def _sync_free_fills():
    """Every dispatch-ahead fill (the speculative and pipelined drivers'
    ``_spec_fill`` / ``_pipe_fill``, the batched engine's ``_pipe_fill``)
    runs under ``torch.cuda.set_sync_debug_mode("error")``: an operation
    inside one that makes the host wait for the card raises. Yields the
    counts of checked fills, and of those that dispatched behind work
    already in flight, per engine class."""
    from videollm_online_tpu_torch.serve.engine import LiveInferEngine
    from videollm_online_tpu_torch.serve.multistream import MultiStreamEngine
    checked = {"fills": 0, "behind": {"LiveInferEngine": 0,
                                      "MultiStreamEngine": 0}}
    saved = []
    for cls, name, queue in ((LiveInferEngine, "_spec_fill", "_inflight"),
                             (LiveInferEngine, "_pipe_fill", "_inflight"),
                             (MultiStreamEngine, "_pipe_fill", "_pipe")):
        fn = getattr(cls, name)

        def fill(self, *a, _fn=fn, _queue=queue, _cls=cls.__name__, **kw):
            before = len(getattr(self, _queue))
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = _fn(self, *a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            checked["fills"] += 1
            if before and len(getattr(self, _queue)) > before:
                checked["behind"][_cls] += 1
            return out

        saved.append((cls, name, fn))
        setattr(cls, name, fill)
    try:
        yield checked
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def _dispatch_drive(engine, feats, feed_every, query_every=8):
    """One drive of a stream (a query every ``query_every`` frames, frames
    fed ``feed_every`` at a time) ending with ``flush()``: the transcript,
    wall seconds, launches and, for a dispatch-ahead driver, its counts."""
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    transcript = (_drive(engine, feats, query_every, feed_every,
                         engine.frame_fps) + engine.flush())
    torch.cuda.synchronize()
    return {"transcript": transcript, "wall_s": time.perf_counter() - t0,
            "launches": _read_launches(), "frames": len(feats),
            "counts": (engine.dispatch_stats()
                       if engine.speculative or engine.pipelined else {})}


def _in_turns(set_mode, run, turns=True):
    """The blocking run and the dispatch-ahead run in turns (blocking,
    ahead, ahead, blocking; without ``turns`` one of each) on one engine:
    ``set_mode(ahead)`` switches it, ``run()`` drives it. Returns (blocking
    runs, ahead runs)."""
    runs = {False: [], True: []}
    for ahead in ((False, True, True, False) if turns else (False, True)):
        set_mode(ahead)
        runs[ahead].append(run())
    set_mode(False)
    return runs[False], runs[True]


def _fps(runs):
    return "/".join(f"{r['frames'] / r['wall_s']:.3f}" for r in runs)


def _dispatch_line(what, runs, blocking, busy=None, ahead=False,
                   rolls=False, batched=False):
    """Print a dispatch-ahead driver's figures beside the blocking engine's
    on the same stream; raise unless every run's transcript is the first
    blocking run's, and, for a run meant to exercise the driver, unless
    every run had two dispatches in flight (``ahead``) and rolled some back
    (``rolls``). A rollback of the batched tick (``batched``) is one
    stream's share of a tick, whose forward ran whole."""
    r, ref = runs[-1], blocking[0]["transcript"]
    n = r["frames"]
    c, k = r["counts"], r["launches"]
    dev = ""
    if busy is not None:
        dev = (f", device {1e3 * busy[0] / busy[2]:.3f} ms a frame against "
               f"{1e3 * busy[1] / busy[2]:.3f} of wall in a profiled drive "
               f"of {busy[2]} frames")
    log(f"{what}: {n} frames, {_fps(runs)} frames/s (blocking "
        f"{_fps(blocking)}), wall {1e3 * r['wall_s'] / n:.3f} ms a "
        f"frame{dev}, {r.get('responses', len(r['transcript']))} responses; "
        f"dispatches "
        f"{c['dispatches']}, most in flight {c['max_inflight']}, rolled back "
        f"{c['rolled_back']} ({c['rolled_back_frames']} frames, "
        + ("stream shares of a tick" if batched else
           f"{32 * c['rolled_back']} K1 launches")
        + f"), resolved {c['resolved']}, "
        f"host wait at resolution {1e3 * c['wait_s']:.2f} ms ("
        f"{1e3 * c['wait_s'] / max(c['resolved'], 1):.3f} a resolution); "
        f"launches K1 "
        f"{k['K1']}, K3 {k['K3']}, K4 {k['K4']}, K5 {k['K5']}")
    for x in runs + blocking:
        if x["transcript"] != ref:
            bad = next((i for i, (a, b) in enumerate(zip(x["transcript"],
                                                         ref)) if a != b),
                       min(len(x["transcript"]), len(ref)))
            raise AssertionError(
                f"{what}: response {bad} differs from the blocking engine's "
                f"({len(x['transcript'])} against {len(ref)} responses)")
    for x in runs:
        if ahead and x["counts"]["max_inflight"] != 2:
            raise AssertionError(f"{what}: never two dispatches in flight")
        if rolls and not x["counts"]["rolled_back"]:
            raise AssertionError(f"{what}: nothing rolled back")


def _busy(drive, frames):
    """(device busy s, wall s, frames) of one profiled drive."""
    busy_us, wall_us, _ = _device_us(drive)
    return busy_us / 1e6, wall_us / 1e6, frames


def phase_main_path_dispatch(n_frames: int = 64, n_fire: int = 10,
                             n_burst: int = 16, ms_frames: int = 32,
                             ms_fire: int = 12):
    """The engines' dispatch-ahead drivers on the main paths, each held to
    the blocking engine's transcript on the same stream, every fill run
    under ``set_sync_debug_mode("error")``. A run whose traffic lets the
    driver run ahead is timed in turns with the blocking engine (blocking,
    ahead, ahead, blocking) and must reach two dispatches in flight; a run
    whose every burst ends at a query turn (the pipe drains there) is run
    once each way, as is the batched run that fires (a response a stream
    at nearly every frame makes it the longest).
    (a) phase 5's 8B int8 stream through ``speculative=True`` fed a frame
    a call and ``pipelined=True`` fed 8 at a time; then, the gate bias
    removed so that the gate fires and dispatches roll back, ``n_fire``
    frames speculative a frame a call and ``n_burst`` frames fed at once
    through the pipelined driver, in the engine's bf16;
    (b) phase 11's int4 stream through serve/cli.py's engine with
    ``--quantize int4 --spec_decode --pipelined`` (K4, K5), then
    ``cli.main`` with ``--pipelined`` on phase 11's 8 frames (its gate
    fires) against phase 11's dialogue;
    (c) phase 15's 8 paged streams through ``pipelined=True`` (depth 2),
    cut to ``ms_frames`` frames a stream; then ``ms_fire`` frames a stream
    with the gate bias removed and one query at t = 0, so that ticks go
    out behind ticks in flight and streams roll back (pages unmapped)."""
    import os

    from videollm_online_tpu_torch.serve import cli
    from videollm_online_tpu_torch.serve.engine import LiveInferEngine
    from videollm_online_tpu_torch.serve.multistream import MultiStreamEngine
    launches = {k: 0 for k in ("K1", "K3", "K4", "K5")}

    def count(runs):
        for r in runs:
            for k in launches:
                launches[k] += r["launches"][k]

    def switch(engine, mode):
        return lambda ahead: setattr(engine, mode, ahead)

    with _sync_free_fills() as checked:
        # (a) phase 5's stream, one engine switched between modes
        cfg, tok, capacity, feats = _int8_stream(n_frames)
        params = _int8_8b(cfg)
        engine = LiveInferEngine(params, tok, cfg, kv_capacity=capacity,
                                 spec_decode=True, device="cuda")
        for mode, feed in (("speculative", 1), ("pipelined", 8)):
            set_mode = switch(engine, mode)
            set_mode(True)
            _dispatch_drive(engine, feats[:16], feed)          # warm-up
            busy = _busy(lambda: _dispatch_drive(engine, feats[:16], feed),
                         16)
            runs_ahead = mode == "speculative"
            blocking, ahead = _in_turns(
                set_mode, lambda: _dispatch_drive(engine, feats, feed),
                turns=runs_ahead)
            _dispatch_line(f"int8, {mode}, {feed} frame(s) a call"
                           + ("" if runs_ahead else
                              ", a query turn ends every burst"),
                           ahead, blocking, busy, ahead=runs_ahead)
            count(ahead)
        # the gate bias removed: the gate fires
        engine.cfg = cfg.replace(gate_logit_bias=0.0)
        blocking, ahead = _in_turns(
            switch(engine, "speculative"),
            lambda: _dispatch_drive(engine, feats[:n_fire], 1))
        _dispatch_line("int8, gate bias 0, speculative, 1 frame a call",
                       ahead, blocking, ahead=True, rolls=True)
        count(ahead)
        blocking, ahead = _in_turns(
            switch(engine, "pipelined"),
            lambda: _dispatch_drive(engine, feats[:n_burst], n_burst,
                                    n_burst))
        _dispatch_line(f"int8, gate bias 0, pipelined, {n_burst} frames at "
                       f"once", ahead, blocking, ahead=True, rolls=True)
        count(ahead)
        if len(blocking[0]["transcript"]) < n_burst // 2:
            raise AssertionError("the gate bias 0 runs fire too seldom")
        engine.cfg = cfg
        del engine
        torch.cuda.empty_cache()

        # (b) phase 11's int4 engine as serve/cli.py builds it, pipelined
        engine, cfg4 = _int4_cli_engine("--pipelined")
        if not engine.pipelined:
            raise AssertionError("--pipelined did not reach the engine")
        feats4 = np.random.RandomState(0).randn(
            n_frames, cfg4.frame_num_tokens, cfg4.vision_hidden_size
        ).astype(np.float32)
        _dispatch_drive(engine, feats4[:16], 8)                # warm-up
        busy = _busy(lambda: _dispatch_drive(engine, feats4[:16], 8), 16)
        blocking, ahead = _in_turns(
            switch(engine, "pipelined"),
            lambda: _dispatch_drive(engine, feats4, 8), turns=False)
        _dispatch_line("int4 (serve/cli.py --pipelined), 8 frames a call, "
                       "a query turn ends every burst", ahead, blocking, busy)
        if not (ahead[0]["launches"]["K4"] and ahead[0]["launches"]["K5"]):
            raise AssertionError(f"int4: launches {ahead[0]['launches']}")
        if ("int4" in _SINGLE_RANK
                and blocking[0]["transcript"] != _SINGLE_RANK["int4"]):
            raise AssertionError("the int4 blocking engine answers otherwise "
                                 "than phase 11's")
        count(ahead)
        del engine
        torch.cuda.empty_cache()
        out_dir = _out_dir("cli_int4_pipelined")
        video = os.path.join(out_dir, "features.npy")
        np.save(video, feats4[:8])
        seen, run = [], cli.run

        def spy(engine, args):
            seen.append(engine)
            return run(engine, args)

        cli.run = spy
        dialogues = {}
        try:
            for flag in ("--pipelined", ""):
                if not flag and "int4_cli" in _SINGLE_RANK:
                    dialogues[flag] = _SINGLE_RANK["int4_cli"]
                    continue
                history = os.path.join(out_dir, f"history{flag}.json")
                with _cli_config(max_response_tokens=20):
                    cli.main(["--video", video, "--model_size", "8b",
                              "--quantize", "int4", "--spec_decode",
                              "--kv_capacity", "8192", "--num_ticks", "8",
                              "--output", history] + ([flag] if flag else []))
                with open(history) as f:
                    h = json.load(f)
                dialogues[flag] = [(m["role"], m["content"])
                                   for m in h["messages"]]
                c = seen[-1].dispatch_stats()
                log(f"cli.main {flag or '(blocking)'}: Average Processing "
                    f"FPS {h['average_processing_fps']:.2f}, "
                    f"{len(h['messages'])} messages; dispatches "
                    f"{c['dispatches']}, rolled back {c['rolled_back']}")
        finally:
            cli.run = run
        if dialogues["--pipelined"] != dialogues[""]:
            raise AssertionError(f"cli --pipelined: {dialogues['--pipelined']}"
                                 f" != {dialogues['']}")
        del seen
        torch.cuda.empty_cache()

        # (c) phase 15's 8 paged streams, cut to ms_frames a stream, on
        # (a)'s weights (phase 15's: the same seed and config)
        ms_capacity, ms_feats = _ms_stream(ms_frames)
        ms = MultiStreamEngine(params, tok, cfg, num_streams=8,
                               kv_capacity=ms_capacity, device="cuda")
        ms.pipelined = True
        _ms_run(ms, ms_feats[:8], 8)                           # warm-up
        busy_us, busy_wall_us, _ = _device_us(
            lambda: _ms_run(ms, ms_feats[:8], 8))

        def ms_run(frames, query_every):
            dt, out, ticks, fwds, n = _ms_run(ms, ms_feats[:frames],
                                              query_every)
            return {"transcript": out, "wall_s": dt, "launches": n,
                    "frames": 8 * frames, "ticks": ticks, "fwds": fwds,
                    "responses": sum(map(len, out)),
                    "counts": ms.dispatch_stats() if ms.pipelined else {}}

        blocking, ahead = _in_turns(switch(ms, "pipelined"),
                                    lambda: ms_run(ms_frames, 8), turns=False)
        _dispatch_line(f"8 paged streams x {ms_frames} frames, pipelined, a "
                       f"query turn ends every burst", ahead, blocking,
                       (busy_us / 1e6, busy_wall_us / 1e6, 64), batched=True)
        log(f"  ticks {ahead[0]['ticks']} (blocking {blocking[0]['ticks']}), "
            f"forwards {ahead[0]['fwds']} (blocking {blocking[0]['fwds']})")
        count(ahead)
        # the gate bias removed and one query at t = 0: ticks go out behind
        # ticks in flight, and a stream whose gate fires rolls back
        ms.cfg = cfg.replace(gate_logit_bias=0.0)
        blocking, ahead = _in_turns(switch(ms, "pipelined"),
                                    lambda: ms_run(ms_fire, ms_fire),
                                    turns=False)
        _dispatch_line(f"8 paged streams x {ms_fire} frames, gate bias 0, "
                       f"pipelined", ahead, blocking, ahead=True, rolls=True,
                       batched=True)
        log(f"  ticks {ahead[0]['ticks']} (blocking {blocking[0]['ticks']}), "
            f"forwards {ahead[0]['fwds']} (blocking {blocking[0]['fwds']})")
        count(ahead)
        del ms, params
        torch.cuda.empty_cache()
    for name, n in checked["behind"].items():
        if not n:
            raise AssertionError(f"no {name} fill dispatched behind work in "
                                 f"flight")
    log(f"dispatch-ahead fills checked under set_sync_debug_mode('error'): "
        f"{checked['fills']} ({checked['behind']} of them behind work in "
        f"flight), none synchronised the host; every transcript "
        f"equals the blocking engine's; launches {launches}")
    return {"launches": launches}

# --------------------------------------------------------------- phase 16
# the demo's options together, on a ring small enough to compact: the
# window, one chunk and one response turn fit (128 + 4 + 8 x 11 + 256 + 16
# <= 640)
DEMO_WINDOW, DEMO_RING = 128, 640


def small_demo_setup(device="cuda"):
    """(cfg, tok, params, vision_params) of the small fp32 demo engine: a
    2-layer LLM (d 64, G 4) and a 2-layer SigLIP at 64 px, from seed 0 on
    ``device`` (tests/test_torch_cuda.py serves the same engine)."""
    from videollm_online_tpu_torch.core.config import (LiveConfig,
                                                       LlamaConfig,
                                                       VisionConfig)
    from videollm_online_tpu_torch.models import live, llama, siglip
    from videollm_online_tpu_torch.tokenizer.live_tokenizer import (
        LiveTokenizer)
    from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer
    lcfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                       num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
                       dtype="float32")
    vcfg = VisionConfig(image_size=64, patch_size=16, hidden_size=64,
                        intermediate_size=128, num_layers=2, num_heads=4,
                        dtype="float32")
    cfg = LiveConfig(llama=lcfg, vision=vcfg, lora=None,
                     vision_hidden_size=64, frame_resolution=64)
    tok = LiveTokenizer(ByteTokenizer(), cfg)
    cfg = tok.cfg.replace(max_response_tokens=16)
    gen = torch.Generator(device=device).manual_seed(0)
    params = {"llama": llama.init_params(gen, cfg.llama, device=device),
              "connector": live.init_connector(gen, cfg, device=device)}
    return cfg, tok, params, siglip.init_params(gen, vcfg, device=device)


def small_demo_drive(setup, frames, *, video_every, device="cuda", **kw):
    """Serve uint8 ``frames`` (T, 3, 64, 64) through a LiveInferEngine with
    every option of the demo path at once (the SigLIP tower on raw frames,
    the int8 KV ring of DEMO_RING compacted to windows of DEMO_WINDOW,
    4-token segments, spec decode): a query every 8 frames, a frame every
    ``video_every``. Returns (transcript, on_delta segments, engine, K1's
    launch count when the ring first compacted, or None)."""
    from videollm_online_tpu_torch.ops.decode_attention import (
        ring_decode_attention_layered as k1)
    from videollm_online_tpu_torch.serve.engine import LiveInferEngine
    cfg, tok, params, vparams = setup
    deltas = []
    eng = LiveInferEngine(
        params, tok, cfg, kv_capacity=DEMO_RING, vision_params=vparams,
        kv_quant="int8", stream_window=DEMO_WINDOW, stream_tokens=4,
        spec_decode=True, device=device,
        on_delta=lambda d, done: deltas.append((d, done)), **kw)
    eng.load_video(frames)
    out, at_compaction = [], None
    for i in range(len(frames)):
        if i % 8 == 0:
            eng.input_query_stream("What happens now?",
                                   video_time=i / eng.frame_fps)
        if i % video_every == video_every - 1:
            eng.input_video_stream(i / eng.frame_fps)
        while True:
            q, r = eng()
            if at_compaction is None and int(eng.cache.pos_base[0]):
                at_compaction = k1.launches
            if r is None:
                break
            out.append((q, r))
    return out, deltas, eng, at_compaction


# --------------------------------------------------------------- phase 15c
# the latent kernel against its plain version at the card test's tolerances
# (tests/test_torch_cuda.py::test_mla_kernel_matches_plain_on_card: the
# kernel rounds P to bf16 before P V, and its output to bf16)
MLA_TOL = {"atol": 1e-2, "rtol": 2e-2, "rel": 5e-3}
# deepseek-v2-lite-bf16.narrate64's latent pool: 64 streams of 28 pages of
# 512 (kv_capacity 14336), caches of 6.6 k to 13.2 k slots, 16 heads
MLA_CELL = {"B": 64, "maxp": 28, "page": 512, "lo": 6600, "hi": 13200,
            "H": 16}
MLA_SCALE = 0.11472    # DeepSeek-V2-Lite's yarn-scaled softmax scale
# the grouped expert products against the loop over the experts, both
# bf16 on the card (another order of the same sums), outputs of unit size
MOE_TOL = {"atol": 5e-2, "rtol": 5e-2, "rel": 2e-2}


def _mla_inputs(S, nvalid, gen, L=2):
    """A latent pool of L layers at the cell's size (unit normals, every
    stream's pages dealt from a permutation, page 0 the trash page),
    queries at stream offsets drawn over the cell's cache lengths, and
    ``nvalid`` (B,) real queries a stream."""
    c = MLA_CELL
    B, maxp, page = c["B"], c["maxp"], c["page"]
    P = B * maxp + 1
    latent = torch.randn((L, P, page, 576), generator=gen, device="cuda"
                         ).to(torch.bfloat16)
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    table = perm.view(B, maxp).to(torch.int32)
    offs = torch.randint(c["lo"], c["hi"] - S + 1, (B,), generator=gen,
                         device="cuda", dtype=torch.int32)
    q_pos = offs[:, None] + torch.arange(S, device="cuda",
                                         dtype=torch.int32)[None]
    q = torch.randn((B, S, c["H"], 576), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    nv = torch.as_tensor(nvalid, dtype=torch.int32, device="cuda")
    return q, latent, table, q_pos, nv


def _mla_poisoned(latent, table, q_pos, nv):
    """The pool with NaN over every row no real query may read: the trash
    page and, in each stream's pages, the slots past its last real query
    (all of a stream with none)."""
    page = latent.shape[2]
    B, maxp = table.shape
    idx = (nv.long() - 1).clamp(min=0)[:, None]
    last = torch.where(nv > 0, q_pos.gather(1, idx)[:, 0], q_pos[:, 0] - 1)
    slot = torch.arange(maxp * page, device=latent.device).view(
        1, maxp, page)
    dead = slot > last[:, None, None].long()             # (B, maxp, page)
    pages = table.long()[:, :, None].expand_as(dead)[dead]
    rows = torch.arange(page, device=latent.device).expand_as(dead)[dead]
    out = latent.clone()
    out[:, 0] = float("nan")
    out[:, pages, rows] = float("nan")
    return out


def _mla_case(label, S, nvalid, gen):
    """The kernel against the plain version on one input at the cell's
    shapes (_repeatable: the wrapper's splits and one split, each twice
    with equal bits; the kernel reads the poisoned pool, the plain version
    the clean one; padding queries and streams with none output 0), then
    timed: the kernel a call from a CUDA graph over the pool's two layers,
    the plain version eagerly, and the bound from 2 H (576 + 512) a
    visible (real query, slot) pair and the visible latent rows plus the
    live streams' q and output."""
    from videollm_online_tpu_torch.ops import mla_attention as ma
    q, latent, table, q_pos, nv = _mla_inputs(S, nvalid, gen)
    L = latent.shape[0]
    layer = L - 1

    def kern(pool, i):
        return ma.mla_paged_attention(q, pool, table, q_pos, i, nv,
                                      scale=MLA_SCALE, dv=512)

    def plain(i):
        return ma.mla_attention_reference(q, latent, table, q_pos, i % L, nv,
                                          scale=MLA_SCALE, dv=512)

    want = plain(layer)
    poisoned = _mla_poisoned(latent, table, q_pos, nv)
    r = _repeatable(f"MLA {label}", lambda: kern(poisoned, layer), want,
                    MLA_TOL, ma)
    got = kern(poisoned, layer)
    real = (torch.arange(S, device="cuda")[None] < nv[:, None])
    if got[~real].any():
        raise AssertionError(f"MLA {label}: a padding query's output is "
                             f"not 0")
    del poisoned, want, got
    torch.cuda.empty_cache()
    t = {"ms": graph_ms(lambda i: kern(latent, i % L), L),
         "plain_ms": cuda_ms(plain, 2, 1), "library_ms": None,
         "splits": ma.num_splits(q.shape[0], S * q.shape[2],
                                 table.shape[1] * latent.shape[2])}
    live = nv > 0
    pairs = int(((q_pos.long() + 1) * real).sum())
    visible = int(torch.where(live, q_pos.max(dim=1).values + 1, 0).sum())
    H = q.shape[2]
    flops = 2 * H * (576 + 512) * pairs
    bytes_ = (visible * 576 * 2
              + int(live.sum()) * S * H * (576 + 512) * 2)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t.update(bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             tflops=flops / t["ms"] / 1e9, mbytes=bytes_ / 1e6)
    log(f"MLA {label} (B {q.shape[0]}, S {S}, {int(live.sum())} streams "
        f"with {int(nv.sum())} real queries, caches {MLA_CELL['lo']} to "
        f"{MLA_CELL['hi']} slots in pages of {MLA_CELL['page']}, H {H}, "
        f"rows of 576 / 512): agrees ({_readings(r)}); kernel {t['ms']:.4f} "
        f"ms a call ({t['splits']} splits, {t['tflops']:.1f} TFLOP/s), plain "
        f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}, {t['mbytes']:.1f} MB, {flops / 1e12:.3f} TFLOP): "
        f"{100 * t['bound_ms'] / t['ms']:.1f} % of the bound")
    del q, latent, table, q_pos, nv
    torch.cuda.empty_cache()
    return r, t


def _moe_case(label, mp, cfg0, T, n_valid, gen):
    """The grouped expert products (``torch._grouped_mm``) against the loop
    over the experts on one layer's weights, T rows of which n_valid are
    real tokens (the others routed nowhere); then each timed eagerly, and
    the whole expert layer."""
    import torch.nn.functional as F
    from videollm_online_tpu_torch.models import deepseek_v2 as ds
    E, k = cfg0.n_routed_experts, cfg0.num_experts_per_tok
    Fe = cfg0.moe_intermediate_size
    x = torch.randn((T, cfg0.hidden_size), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    valid = torch.arange(T, device="cuda") < n_valid
    _, e = ds.route(x, mp["gate"], cfg0)
    key = torch.where(valid[:, None], e, E).reshape(-1)
    order = torch.argsort(key, stable=True)
    per = torch.zeros((E + 1,), dtype=torch.int64, device="cuda")
    per.scatter_add_(0, key, torch.ones_like(key))
    xs = x[order // k]
    routed = int(per[:E].sum())

    def grouped(i=0):
        return ds._expert_products(xs, per[:E], mp["w_gate_up"],
                                   mp["w_down"])

    def loop(i=0):
        out = torch.zeros_like(xs)
        s = 0
        for j, n in enumerate(per[:E].tolist()):
            if n:
                h = xs[s:s + n] @ mp["w_gate_up"][j]
                out[s:s + n] = (F.silu(h[:, :Fe]) * h[:, Fe:]) @ mp[
                    "w_down"][j]
                s += n
        return out

    r = _close(f"MoE {label}", grouped()[:routed], loop()[:routed], MOE_TOL)
    t = {"grouped_ms": cuda_ms(grouped, 10), "loop_ms": cuda_ms(loop, 3, 1),
         "layer_ms": cuda_ms(lambda i: ds.moe(x, mp, cfg0, valid, None), 10)}
    log(f"MoE {label} ({T} rows, {n_valid} real tokens, {routed} routed "
        f"pairs, {E} experts of {Fe}): grouped products agree with the loop "
        f"({_readings(r)}); grouped {t['grouped_ms']:.4f} ms, loop "
        f"{t['loop_ms']:.4f} ms, the whole layer {t['layer_ms']:.4f} ms")
    return r, t


def phase_mla(n_streams: int = 8, n_frames: int = 64, layers: int = 3):
    """DeepSeek-V2's latent attention kernel (``ops/mla_attention.py``,
    ``csrc/mla_attention.cu``) held to its plain version and timed at
    deepseek-v2-lite-bf16.narrate64's shapes (a decode forward: 64
    streams, 2 with a query; an ingest tick: 64 streams x 88 queries, a
    few with padding); then the main path: a MultiStreamEngine over
    DeepSeek-V2-Lite's widths at ``layers`` layers (layer 0 dense, the
    rest 64 experts) with phase 15's traffic, the launch count set to 0
    just before the counted run and read after it (one launch a layer a
    forward, counted as _CountForwards counts them), the decode graph
    replayed; then the expert layer's grouped products against the expert
    loop, at a decode forward's and an ingest tick's rows."""
    from videollm_online_tpu_torch.core.config import (DeepseekV2Config,
                                                       LiveConfig)
    from videollm_online_tpu_torch.models import deepseek_v2 as ds
    from videollm_online_tpu_torch.models import live
    from videollm_online_tpu_torch.ops import mla_attention as ma
    from videollm_online_tpu_torch.serve.multistream import MultiStreamEngine
    from videollm_online_tpu_torch.tokenizer.live_tokenizer import (
        LiveTokenizer)
    from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer
    gen = torch.Generator(device="cuda").manual_seed(21)
    B = MLA_CELL["B"]
    decode_nv = [0] * B
    decode_nv[5] = decode_nv[40] = 1
    ingest_nv = [88] * B
    ingest_nv[3], ingest_nv[17], ingest_nv[60] = 60, 1, 87
    readings, timing = [], {}
    for label, S, nv in (("decode", 1, decode_nv), ("ingest", 88, ingest_nv)):
        r, timing[label] = _mla_case(label, S, nv, gen)
        readings.append(r)

    cfg0 = DeepseekV2Config(num_layers=layers)
    cfg = LiveConfig(llama=cfg0, lora=None)
    tok = LiveTokenizer(ByteTokenizer(), cfg)
    query_every = 8
    cfg = tok.cfg.replace(frame_token_interval_threshold=0.725,
                          max_response_tokens=20, gate_logit_bias=30.0)
    fnt = cfg.frame_num_tokens
    capacity = 256 * ((n_frames * (fnt + 4) + 128 + (n_frames // 8 + 2)
                       * (128 + 20)) // 256 + 1)
    params = {"llama": ds.init_params(gen, cfg0, device="cuda"),
              "connector": live.init_connector(gen, cfg, device="cuda")}
    feats = np.random.RandomState(7).randn(
        n_frames, fnt, cfg.vision_hidden_size).astype(np.float32)
    ms = MultiStreamEngine(params, tok, cfg, num_streams=n_streams,
                           kv_capacity=capacity, device="cuda")
    _ms_run(ms, feats[:16], query_every)                        # warm-up
    ms.reset()
    torch.cuda.synchronize()
    ma.mla_paged_attention.launches = 0
    with _CountForwards(ds) as fc:
        t0 = time.perf_counter()
        for i in range(ms.N):
            _ms_admit(ms, i, feats, query_every)
        out, ticks = _ms_drain(ms)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = ma.mla_paged_attention.launches
    c = ms.counters()
    n_resp = sum(map(len, out))
    if n_resp < n_streams * (n_frames // query_every) or not all(
            "Assistant:" in r for o in out for _, r in o):
        raise AssertionError(f"MLA main path: responses {out}")
    if launches != layers * fc.n:
        raise AssertionError(f"MLA main path: {launches} launches over "
                             f"{fc.n} launching forwards (want {layers} a "
                             f"forward)")
    if not c["decode_graph_replays"]:
        raise AssertionError(f"MLA main path: the decode graph never "
                             f"replayed ({c})")
    frames = n_streams * n_frames
    log(f"MLA main path (DeepSeek-V2-Lite widths, {layers} layers, "
        f"{n_streams} streams x {n_frames} frames, a query every "
        f"{query_every}, kv_capacity {capacity}, pool {ms.pool_pages} pages "
        f"of {ms.page_size}): {frames / dt:.3f} frames/s, {n_resp} "
        f"responses, {ticks} ticks, {fc.n} launching forwards, "
        f"{launches} MLA launches; decode forwards {c['decode_forwards']}, "
        f"graph captures {c['decode_graph_captures']}, replays "
        f"{c['decode_graph_replays']}; expert layer calls "
        f"{c['moe_layer_calls']}, imbalance 64 x peak / pairs "
        f"{64 * c['moe_peak_pairs'] / max(c['moe_pairs'], 1):.3f}")
    log(f"  first response: {out[0][0]!r}")
    del ms
    mp = {name: w[0] for name, w in params["llama"]["moe"].items()}
    moe = {}
    for label, T, n_valid in (("decode", 64, 2), ("ingest", 5824, 5600)):
        r, moe[label] = _moe_case(label, mp, cfg0, T, n_valid, gen)
    del params, mp
    torch.cuda.empty_cache()
    result = {"max_abs_err": _worst(readings)["max"], "launches": launches,
              "timing": timing, "moe": moe, **timing["ingest"]}
    log("MLA kernel line: " + json.dumps({
        "name": "mla_paged_attention", "launches": launches,
        "max_abs_err": result["max_abs_err"],
        **{key: timing["ingest"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "decode": {key: timing["decode"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by")}}))
    return result


def phase_small_demo():
    """The small fp32 engine with every option of the demo path at once,
    run through the kernels and through the plain attention: the
    transcripts and every on_delta segment must be equal, the ring must
    have compacted, and K1 (its int8 form, FMA design at fp32 queries) must
    launch after the first compaction."""
    from videollm_online_tpu_torch.models import llama
    from videollm_online_tpu_torch.ops.decode_attention import (
        ring_decode_attention_layered as k1)
    setup = small_demo_setup()
    res = setup[0].vision.image_size
    frames = np.random.RandomState(0).randint(
        0, 256, (48, 3, res, res)).astype(np.uint8)
    k1.launches = 0
    got, got_deltas, eng, at_compaction = small_demo_drive(
        setup, frames, video_every=2)
    n_k1 = k1.launches
    plain, plain_deltas, _, _ = small_demo_drive(
        setup, frames, video_every=2, attn_impl=llama._attention)
    if got != plain or got_deltas != plain_deltas:
        raise AssertionError(f"kernel and plain runs differ:\n{got}\n{plain}")
    if eng.cache.k.dtype != torch.int8 or at_compaction is None:
        raise AssertionError(f"ring {eng.cache.k.dtype}, compacted "
                             f"{at_compaction is not None}")
    if not got or n_k1 - at_compaction == 0:
        raise AssertionError(f"responses {len(got)}, K1 launches {n_k1}, "
                             f"{n_k1 - (at_compaction or 0)} after the first "
                             f"compaction")
    segments = sum(not done for _, done in got_deltas)
    log(f"small demo (fp32, SigLIP {res} px on raw frames, int8 KV ring of "
        f"{DEMO_RING} compacted to windows of {DEMO_WINDOW}, 4-token "
        f"segments, spec decode): {len(got)} responses, "
        f"{len(got_deltas)} on_delta segments ({segments} not final), "
        f"pos_base {int(eng.cache.pos_base[0])}; equal transcripts and "
        f"segments through K1's int8 form ({n_k1} launches, "
        f"{n_k1 - at_compaction} after the first compaction) and the plain "
        f"attention")


# --------------------------------------------------------------- phase 17
# SigLIP-large on the card: bf16 frame features against the same weights
# in fp32, relative norm over 16 demo frames. The first readings, over 64
# frames in batches of 16, were 3.25e-3 at most (3.22e-3 mean); the bound
# is about three times that.
DEMO_ENC_REL = 1e-2
# the main paths' response length and gate bias (phases 5, 11, 15): random
# weights fire the gate on every frame, and a bias of 30 holds it silent
# but for the opening query, as a trained model is silent most of the time
DEMO_RESPONSE_TOKENS, DEMO_GATE_BIAS = 20, 30.0


@contextlib.contextmanager
def _cli_config(**fields):
    """serve/cli.py builds its LiveConfig with these fields replaced, so
    the engine derives its response budget, segments and draft length
    from them as for any config."""
    from videollm_online_tpu_torch.serve import cli
    make = cli.live1_plus_config
    cli.live1_plus_config = lambda **kw: make(**kw).replace(**fields)
    try:
        yield
    finally:
        cli.live1_plus_config = make


def _demo_frames(n, res, seed):
    """n RGB frames (n, res, res, 3) uint8 from seed: a noise field that
    drifts right by 6 px a frame and a white square crossing it."""
    rng = np.random.RandomState(seed)
    field = rng.randint(0, 256, (res, res, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:res, :res]
    out = np.empty((n, res, res, 3), np.uint8)
    for i in range(n):
        out[i] = np.roll(field, 6 * i, axis=1)
        cx = (i * res) // n
        out[i][(abs(yy - res // 2) < res // 8) & (abs(xx - cx) < res // 8)] = 255
    return out


def _device_us(fn):
    """fn()'s device time under torch.profiler (us), and its host wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if "CUDA" in str(e.device_type))
    return busy, wall, out


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def phase_main_path_demo(n_frames: int = 64, seed: int = 0):
    """The upstream demo's path at full width: a synthetic .avi of n_frames
    384 px frames written by the port's write_avi, served by serve/cli.py
    (build_engine, then the loop of main) with --model_size 8b
    --with_vision --spec_decode: once --quantize int8 --kv_quant int8
    --stream_tokens 4, once --quantize int4. Random SigLIP-large and 8B
    weights are built on the card; the config carries the main paths'
    20-token responses and gate bias, so the engine answers the opening
    query (in 4-token segments on the int8 run) and stays silent through
    the video. Prints Average Processing FPS, the K1 / K4 / K5 launches of
    that run, the encoder's ms a frame (CUDA events) and device time, and
    the wall against the device time of one tick; holds the tower's bf16
    features to the same weights in fp32."""
    import os

    from videollm_online_tpu_torch.data import avi
    from videollm_online_tpu_torch.models import live, quant, siglip
    from videollm_online_tpu_torch.serve import cli

    out_dir = _out_dir("demo")
    video = os.path.join(out_dir, "demo.avi")
    res = 384
    avi.write_avi(video, _demo_frames(n_frames, res, seed), fps=2.0)
    log(f"demo video: {n_frames} frames of {res} px, "
        f"{os.path.getsize(video) / 2**20:.1f} MiB rawvideo .avi")
    results = {}
    for label, extra in (("int8", ["--quantize", "int8", "--kv_quant", "int8",
                                   "--stream_tokens", "4"]),
                         ("int4", ["--quantize", "int4"])):
        args = cli.parse_args(
            ["--video", video, "--model_size", "8b", "--with_vision",
             "--spec_decode", "--seed", str(seed), "--num_ticks",
             str(n_frames + 1), "--output",
             os.path.join(out_dir, f"history_{label}.json")] + extra)
        t0 = time.perf_counter()
        with _cli_config(max_response_tokens=DEMO_RESPONSE_TOKENS,
                         gate_logit_bias=DEMO_GATE_BIAS):
            engine, cfg = cli.build_engine(args)
        torch.cuda.synchronize()
        log(f"demo {label}: engine built by serve/cli.py in "
            f"{time.perf_counter() - t0:.2f} s: 8B parameters "
            f"{quant.param_bytes(engine.params) / 2**30:.2f} GiB, SigLIP-large "
            f"{quant.param_bytes(engine.vision_params) / 2**30:.3f} GiB "
            f"({cfg.vision.dtype}), KV ring {engine.kv_capacity} "
            f"({engine.cache.k.dtype}), responses of {engine.max_new} "
            f"tokens a call")
        segments = []
        if engine.on_delta is not None:
            printed = engine.on_delta
            engine.on_delta = lambda d, done: (segments.append(done),
                                               printed(d, done))
        _zero_launches()
        t0 = time.perf_counter()
        history, ticks = cli.run(engine, args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_launches()
        responses = [m["content"] for m in history["messages"]
                     if m["role"] == "assistant"]
        want = ("K1",) + (("K4", "K5") if label == "int4" else ())
        if not responses or min(counts[k] for k in want) == 0:
            raise AssertionError(f"demo {label}: responses {len(responses)},"
                                 f" launches {counts}")
        if not all("Assistant:" in r for r in responses):
            raise AssertionError(f"malformed responses: {responses[:2]}")
        kv_dtype = torch.int8 if label == "int8" else torch.bfloat16
        if engine.cache.k.dtype != kv_dtype:
            raise AssertionError(f"KV ring {engine.cache.k.dtype}")
        if label == "int8" and segments.count(False) < 1:
            raise AssertionError(f"on_delta segments {segments}: want the "
                                 f"response in more than one")
        fps = history["average_processing_fps"]
        silent = [dt for dt, spoke in ticks if not spoke]
        tick_ms = 1e3 * np.mean(silent) if silent else float("nan")
        steps, emitted = (int(x) for x in engine.spec_stats())
        log(f"demo {label}: Average Processing FPS {fps:.3f} over "
            f"{len(ticks)} ticks ({wall:.2f} s in all), {len(responses)} "
            f"responses ({len(ticks) - len(silent)} in the timed ticks), "
            f"{len(segments)} on_delta segments, silent ticks at "
            f"{tick_ms:.2f} ms; spec {steps} verify steps -> {emitted} "
            f"tokens")
        log(f"demo {label} launches: {counts}")
        log(f"demo {label} first response: {responses[0]!r}")

        # the encoder on one frame, as each tick runs it
        frames_np = engine.video_tensor
        px = torch.from_numpy(frames_np[:1]).cuda()
        enc_ms = cuda_ms(lambda i: live.pixels_to_embeds(
            engine.vision_params, engine.params, px, cfg), 20)
        enc_dev_us, _, _ = _device_us(lambda: live.pixels_to_embeds(
            engine.vision_params, engine.params, px, cfg))
        # one silent tick of a fresh dialogue on the same engine, profiled:
        # the fifth, after the query's answer and three more
        engine.reset()
        engine.load_video(frames_np)
        engine.input_query_stream(args.query, video_time=0.0)
        for i in range(4):
            engine.input_video_stream(i / engine.frame_fps)
            engine()
        tick_busy, tick_wall, (_, r) = _device_us(lambda: (
            engine.input_video_stream(4 / engine.frame_fps), engine())[1])
        log(f"demo {label}: encoder (SigLIP-large + connector, 1 frame) "
            f"{enc_ms:.3f} ms a frame by CUDA events, device "
            f"{enc_dev_us / 1e3:.3f} ms: {100 * enc_ms / tick_ms:.1f} % of "
            f"a silent tick; one profiled tick "
            f"({'a response' if r else 'silent'}): wall "
            f"{tick_wall / 1e3:.2f} ms, device busy {tick_busy / 1e3:.2f} ms "
            f"({100 * tick_busy / tick_wall:.1f} %)")
        results[label] = {"launches": counts, "fps": fps, "enc_ms": enc_ms}

        if label == "int8":
            # the tower's bf16 features against the same weights in fp32
            x = siglip.preprocess(torch.from_numpy(frames_np[:16]).cuda(),
                                  cfg.vision)
            v32 = _cast_tree(engine.vision_params, torch.float32)
            got = siglip.frame_features(engine.vision_params, x, cfg.vision,
                                        cfg).float()
            ref = siglip.frame_features(v32, x, cfg.vision, cfg)
            if got.shape != (len(x), cfg.frame_num_tokens,
                             cfg.vision_hidden_size) or not bool(
                    torch.isfinite(got).all()):
                raise AssertionError(f"bad features {tuple(got.shape)}")
            rel = float((got - ref).norm() / ref.norm())
            log(f"demo SigLIP-large features, bf16 vs fp32 weights on "
                f"{len(x)} frames: relative norm error {rel:.3e} (bound "
                f"{DEMO_ENC_REL:.0e})")
            if not rel <= DEMO_ENC_REL:
                raise AssertionError(f"features {rel:.3e} from fp32")
            del v32
        del engine
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------- phase 18
# The small evaluator through K2f against the plain attention, per position
# (fp32, the FMA design of K2f): the bound sits well above fp32 rounding of
# a 2-layer forward and far below any change of an argmax's margin.
EVAL_NLL_ATOL = 1e-4
# new tokens of evaluate_entry's COIN greedy decode (phase 18) and of the
# LTA beam search (phase 19), cut from the datasets' 512 to keep the run
# short: random weights never end a response early
EVAL_COIN_NEW, EVAL_BEAM_NEW = 64, 64


def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _stream_sample(tok, cfg, n_frames, turn_every, texts, seed):
    """A narration eval sample through the port's data path (chat template
    -> learn ranges -> collator), as benchmarks/eval_bench.py builds it: a
    turn every ``turn_every`` frames, each narration padded to 40
    characters."""
    from videollm_online_tpu_torch.data.collator import collate
    conv = [{"role": "system", "content": "You are a narrator."}]
    for i in range(n_frames // turn_every):
        conv += [{"role": "stream", "num_frames": turn_every, "learn": True},
                 {"role": "assistant", "content": f"{texts[i]:<40}",
                  "learn": True}]
    frames = np.random.RandomState(seed).randn(
        n_frames, cfg.frame_num_tokens, cfg.vision_hidden_size).astype(
        np.float32)
    return collate([(tok.apply_chat_template(conv), frames,
                     tok.get_learn_ranges(conv), 0, None)], tokenizer=tok)


def _synth_narration(rng, n_rows):
    """Narration rows with the text shape of cleaned Ego4D narrations
    ("You pick up the knife."), Zipf-weighted verbs and objects: the rows
    bench.py's synth_narration draws, from the same seed."""
    verbs = ["look around", "pick up", "put down", "hold", "cut", "stir",
             "open", "close", "move", "wash", "place", "turn", "pour",
             "grab", "wipe", "push"]
    objs = ["the knife", "a bowl", "the pan", "the vegetables",
            "the cupboard", "the tap", "the dough", "a spoon", "the plate",
            "the cloth", "the bottle", "the lid", "some water", "the box",
            "the drawer", "a bag"]
    tails = ["", "", "", "", " with your right hand", " on the table",
             " in the kitchen", " again"]

    def pick(items):
        w = 1.0 / np.arange(1, len(items) + 1)
        return items[rng.choice(len(items), p=w / w.sum())]

    rows = []
    for _ in range(n_rows):
        v = pick(verbs)
        rows.append(f"You look around{pick(tails)}." if v == "look around"
                    else f"You {v} {pick(objs)}{pick(tails)}.")
    return rows


def _lta_prompt(tok, cfg, n_frames=32, seed=9):
    """One LTA-shaped prompt (frames and a forecasting query), as
    benchmarks/eval_bench.py builds it."""
    from videollm_online_tpu_torch.data.collator import collate
    conv = [{"role": "system", "content": "You are an anticipator."},
            {"role": "stream", "num_frames": n_frames, "learn": False},
            {"role": "user", "content": "What will happen next?"}]
    frames = np.random.RandomState(seed).randn(
        n_frames, cfg.frame_num_tokens, cfg.vision_hidden_size).astype(
        np.float32)
    batch = collate([(tok.apply_chat_template(conv,
                                              add_generation_prompt=True),
                      frames, [], 0, None)], tokenizer=tok)
    return batch["input_ids"], batch["frames"]


@contextlib.contextmanager
def _coin_eval(root, max_new_tokens):
    """The COIN datasets read a synthetic tree under ``root``
    (tests/_synthetic.py's, a module of json, os and numpy only) and
    generate ``max_new_tokens``; both are put back on the way out."""
    import pathlib
    from videollm_online_tpu_torch.data.coin import base as coin_base
    from videollm_online_tpu_torch.data.coin import benchmarks
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"))
    try:
        from _synthetic import make_coin_root
    finally:
        sys.path.pop(0)
    bench = benchmarks.COINBenchmark
    saved = coin_base.COIN.root, bench.evaluation_kwargs
    coin_base.COIN.root = make_coin_root(root, dim=1024)
    bench.evaluation_kwargs = dict(saved[1], max_new_tokens=max_new_tokens)
    try:
        yield
    finally:
        coin_base.COIN.root, bench.evaluation_kwargs = saved


def phase_small_eval():
    """The offline evaluators on a small fp32 model (d 64, so the prefill
    takes K2f and decode K1): StreamEvaluator through K2f and through the
    plain attention (the four metrics equal, the per-position NLL within
    EVAL_NLL_ATOL), beam_generate and greedy_from_embeds through K1 and
    through the plain attention (the same ids), then evaluate_entry itself
    on a synthetic COIN root at the 1B proxy (d 64), printing its
    metrics."""
    import tempfile

    from videollm_online_tpu_torch.core.config import (LlamaConfig,
                                                       tiny_live_config)
    from videollm_online_tpu_torch.eval import generation
    from videollm_online_tpu_torch.eval import stream_evaluate as se
    from videollm_online_tpu_torch.evaluate_entry import evaluate
    from videollm_online_tpu_torch.models import live, llama
    from videollm_online_tpu_torch.tokenizer.live_tokenizer import (
        LiveTokenizer)
    from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer
    cfg = tiny_live_config(llama=LlamaConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
        dtype="float32"))
    tok = LiveTokenizer(ByteTokenizer(), cfg)
    cfg = tok.cfg
    params = live.init_params(torch.Generator(device="cuda").manual_seed(0),
                              cfg, device="cuda")
    batch = _stream_sample(tok, cfg, 40, 5, _synth_narration(
        np.random.RandomState(0), 8), seed=1)
    counts = _all_launch_counters()
    n0 = counts["K2f"].launches
    got = se.StreamEvaluator(params, cfg)(
        batch["input_ids"], batch["labels"], batch["frames"], 0.5)
    n_k2f = counts["K2f"].launches - n0
    want = se.StreamEvaluator(params, cfg, attn_impl=llama._attention)(
        batch["input_ids"], batch["labels"], batch["frames"], 0.5)
    if n_k2f != cfg.llama.num_layers or not np.array_equal(got[1:],
                                                           want[1:]):
        raise AssertionError(f"K2f launches {n_k2f}; metrics {got} through "
                             f"K2f, {want} plain")
    # per position: the stats of one padded prefill through each route
    T = -(-batch["input_ids"].shape[1] // 128) * 128
    pad = T - batch["input_ids"].shape[1]
    ids = torch.from_numpy(np.pad(batch["input_ids"], ((0, 0), (0, pad)),
                                  constant_values=cfg.eos_token_id)).cuda()
    lab = torch.from_numpy(np.pad(batch["labels"], ((0, 0), (0, pad)),
                                  constant_values=-100)).cuda()
    frames = torch.from_numpy(batch["frames"]).cuda()
    stats = []
    with torch.no_grad():
        for attn in (se._prefill_attn, llama._attention):
            cache = llama.init_kv_cache(cfg.llama, 1, T, device="cuda")
            stats.append(se._per_token_stats(params, cfg, ids, lab, frames,
                                             cfg.frame_token_interval_id,
                                             cache, attn))
    nll_err = float(np.abs(stats[0][0] - stats[1][0]).max())
    same_argmax = all(np.array_equal(a, b) for a, b in zip(stats[0][1:3],
                                                           stats[1][1:3]))
    if not nll_err <= EVAL_NLL_ATOL or not same_argmax:
        raise AssertionError(f"per-position NLL {nll_err:.3g}, argmaxes "
                             f"equal {same_argmax}")
    log(f"small eval (fp32, d 64, T {batch['input_ids'].shape[1]} padded to "
        f"{T}, 8 turns, threshold 0.5): metrics {got.tolist()} through K2f "
        f"({n_k2f} launches) equal the plain attention's; per-position NLL "
        f"max |diff| {nll_err:.3g} (bound {EVAL_NLL_ATOL:.0e}), argmaxes "
        f"equal")

    prompt, pframes = _lta_prompt(tok, cfg, n_frames=8)
    kw = dict(num_beams=5, max_new_tokens=24, num_return_sequences=5)
    n0 = counts["K1"].launches
    beams = generation.beam_generate(params, cfg, prompt, pframes, **kw)
    n_k1 = counts["K1"].launches - n0
    searcher = generation.BeamSearcher(params, cfg, 5,
                                       attn_impl=llama._attention)
    plain = searcher.search(prompt, pframes, max_new_tokens=24,
                            num_return_sequences=5)
    plain_rows = np.full(beams.shape, -100)
    for i, s in enumerate(plain):
        plain_rows[i, :len(s)] = s
    greedy = [generation.greedy_from_embeds(params, cfg, prompt, pframes,
                                            max_new_tokens=24,
                                            attn_impl=attn)
              for attn in (None, llama._attention)]
    if (n_k1 == 0 or not np.array_equal(beams, plain_rows)
            or not np.array_equal(*greedy)):
        raise AssertionError(f"K1 launches {n_k1}; beams equal "
                             f"{np.array_equal(beams, plain_rows)}, greedy "
                             f"equal {np.array_equal(*greedy)}")
    log(f"small beam search (fp32, 5 beams at B 5, 24 new tokens, prompt "
        f"{prompt.shape[1]} tokens): the same ids through K1 ({n_k1} "
        f"launches) and the plain attention; greedy_from_embeds too "
        f"({greedy[0].shape[1]} tokens)")

    with tempfile.TemporaryDirectory() as tmp, \
            _coin_eval(tmp, EVAL_COIN_NEW):
        n0 = counts["K1"].launches
        t0 = time.perf_counter()
        metrics = evaluate([
            "--live_version", "live1+", "--model_size", "1b",
            "--eval_datasets", "coin_step_test", "--pad_to_multiple", "16",
            "--output_dir", tmp + "/out"])
        dt = time.perf_counter() - t0
        with open(tmp + "/out/eval_results.json") as f:
            written = json.load(f)
    if written != metrics or "accuracy" not in metrics["coin_step_test"]:
        raise AssertionError(f"evaluate_entry wrote {written}, returned "
                             f"{metrics}")
    _SINGLE_RANK["coin_eval"] = metrics
    log(f"evaluate_entry on a synthetic COIN root (coin_step_test, 2 "
        f"samples, greedy {EVAL_COIN_NEW} new tokens, cut from the "
        f"dataset's 512; 1B proxy bf16 random weights): "
        f"{metrics} in {dt:.1f} s, K1 launches "
        f"{counts['K1'].launches - n0} [{_card()}]")


def _eval_k2f(T, sliding_window=None):
    """K2f at the eval prefill's shapes (the 8B heads, bf16) on a ring
    sliced to T, held against its plain version query chunk by query
    chunk (the whole (Hq, T, T) fp32 scores would not fit), and timed by
    CUDA events beside the plain version (the same chunks), SDPA on the
    sliced ring and the bound; and the cost of making the ring's slice
    contiguous (one copy of K and of V a layer)."""
    from videollm_online_tpu_torch.eval import stream_evaluate as se
    from videollm_online_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(4)
    Hq, Hkv, d, C = 32, 8, 128, T + 990
    q = torch.randn(1, Hq, T, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(1, Hkv, C, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(1, Hkv, C, d, generator=gen, device="cuda").bfloat16()
    q_pos = torch.arange(T, device="cuda")[None]
    scale = d ** -0.5
    out = se._prefill_attn(q, k, v, q_pos, None, num_groups=Hq // Hkv)
    chunk = 2048
    err = {"max": 0.0, "atol": 0.0, "rel": 0.0, "median": 0.0}
    for r in range(0, T, chunk):
        want, _ = fa.flash_attention_fwd_reference(
            q[:, :, r:r + chunk], k[:, :, :T], v[:, :, :T], scale, True, r)
        got = _close(f"K2f eval prefill rows {r}:", out[:, :, r:r + chunk],
                     want, K2_TOL[torch.bfloat16])
        err = {n: max(err[n], got[n]) for n in err}
        del want
    ks, vs = k[:, :, :T].contiguous(), v[:, :, :T].contiguous()
    # SDPA on K/V expanded to the query heads (its GQA form may take the
    # math route, whose (Hq, T, T) scores do not fit at this T)
    kx, vx = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (ks, vs))
    t = {"ms": cuda_ms(lambda _: se._prefill_attn(
             q, k, v, q_pos, None, num_groups=Hq // Hkv), 10, 2),
         "kernel_ms": cuda_ms(lambda _: fa.flash_fwd(q, ks, vs, scale),
                              10, 2),
         "slice_copy_ms": cuda_ms(lambda _: (k[:, :, :T].contiguous(),
                                             v[:, :, :T].contiguous()),
                                  10, 2),
         "plain_ms": cuda_ms(lambda _: [fa.flash_attention_fwd_reference(
             q[:, :, r:r + chunk], ks, vs, scale, True, r)
             for r in range(0, T, chunk)], 2, 1),
         "library_ms": cuda_ms(lambda _: torch.nn.functional.
                               scaled_dot_product_attention(
                                   q, kx, vx, is_causal=True, scale=scale),
                               10, 2)}
    pairs = Hq * T * (T + 1) // 2
    flops = 4 * d * pairs
    bytes_ = 2 * q.numel() * 2 + 2 * ks.numel() * 2 + Hq * T * 4
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S * 1e3, \
        bytes_ / HBM_BYTES_PER_S * 1e3
    t.update(bound_ms=max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             max_abs_err=err["max"], rel=err["rel"])
    del q, k, v, ks, vs, kx, vx, out
    torch.cuda.empty_cache()
    return t


EVAL_KERNEL_CLASSES = (("K2f", ("k2_fwd",)),
                       ("K1", ("ringpool", "decode_merge")),
                       ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
                       ("cast copies", ("copy_kernel",)))


def _profile_eval(fn, what, card):
    """fn() once under torch.profiler: its wall, the card's busy time and
    the busy time by kernel class, with the largest kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if "CUDA" in str(e.device_type) and e.self_device_time_total]
    busy = sum(t for _, t, _ in kernels)
    if not busy:
        log(f"profile of {what}: the profiler saw no device time (not "
            f"measured)")
        return
    shares = dict.fromkeys([n for n, _ in EVAL_KERNEL_CLASSES] + ["other"],
                           0.0)
    for key, t, _ in kernels:
        shares[next((n for n, marks in EVAL_KERNEL_CLASSES
                     if any(m in key.lower() for m in marks)), "other")] += t
    log(f"profile of {what}: wall {wall:.1f} ms under the profiler, device "
        f"busy {busy:.1f} ms ({100 * busy / wall:.1f}% of wall), by class "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in shares.items())
        + f" [{card}]")
    for key, t, n in sorted(kernels, key=lambda k: -k[1])[:6]:
        log(f"  {t:10.2f} ms  x{n:<6d} {key[:110]}")


def _k1_beam_hold(cache, prompt_len, Hq):
    """K1 held against its plain version on the LTA beam search's own ring
    as the search left it (B 5, bf16, Hkv 8, d 128: the tensor-core
    design), with random S 1 queries at the prompt's last slot, midway and
    the last slot written, at the first and the last layer (_repeatable:
    the wrapper's split count and one split, at K1_TOL); returns the worst
    readings and the query positions."""
    from videollm_online_tpu_torch.ops import decode_attention as da
    gen = torch.Generator(device="cuda").manual_seed(12)
    L, B, _, _, d = cache.k.shape
    last = int(cache.offset.max()) - 1
    positions = sorted({prompt_len - 1, (prompt_len - 1 + last) // 2, last})
    readings = []
    for pos in positions:
        q = torch.randn((B, Hq, 1, d), generator=gen,
                        device="cuda").to(cache.k.dtype)
        q_pos = torch.full((B, 1), pos, dtype=torch.int32, device="cuda")
        for layer in (0, L - 1):
            want = da.ring_decode_attention_layered_reference(
                q, cache.k, cache.v, q_pos, layer)
            readings.append(_repeatable(
                f"K1 beam ring layer {layer} q_pos {pos} B {B} d {d} "
                f"{da.kernel_design(q.dtype, d)}",
                lambda: da.ring_decode_attention_layered(
                    q, cache.k, cache.v, q_pos, layer),
                want, K1_TOL[q.dtype], da))
    return _worst(readings), positions


def phase_main_path_eval(minutes: float = 10.0, turn_every: int = 10,
                         samples: int = 2, beam_new: int = EVAL_BEAM_NEW):
    """The offline-evaluation main path at full Llama-3-8B width and depth:
    an int8 base with bf16 LoRA (r 128) and connector, random, built on the
    card as benchmarks/eval_bench.py builds them; one 10-minute live1+
    narration sample (1200 frames, a turn every 10, threshold 0.725)
    through StreamEvaluator: s/video, ms/turn, videos/hour, T, the
    rollforward's time on its own, K2f's launches (one per layer a sample);
    K2f at that T held against its plain version and timed beside it, SDPA
    and the bound; the chunked int8 lm_head's time; then one LTA beam
    search with 5 beams at B 5 through K1 (``beam_new`` new tokens: cut
    from the dataset's 512 to keep the run short), and K1 held against its
    plain version on the ring that search left."""
    from videollm_online_tpu_torch.core.config import (LiveConfig,
                                                       LlamaConfig,
                                                       LoraConfig)
    from videollm_online_tpu_torch.eval import generation
    from videollm_online_tpu_torch.eval import stream_evaluate as se
    from videollm_online_tpu_torch.models import llama
    from videollm_online_tpu_torch.tokenizer.live_tokenizer import (
        LiveTokenizer)
    from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer
    card = _card()
    lcfg = LlamaConfig(vocab_size=128256, hidden_size=4096,
                       intermediate_size=14336, num_layers=32, num_heads=32,
                       num_kv_heads=8, head_dim=128, dtype="bfloat16")
    tok = LiveTokenizer(ByteTokenizer(),
                        LiveConfig(llama=lcfg, lora=LoraConfig()))
    cfg = tok.cfg
    params = _lora_8b_params(cfg,
                             torch.Generator(device="cuda").manual_seed(0))
    n_frames = int(minutes * 60 * cfg.frame_fps)
    n_frames -= n_frames % turn_every
    n_turns = n_frames // turn_every
    texts = _synth_narration(np.random.RandomState(0), n_turns)
    batches = [_stream_sample(tok, cfg, n_frames, turn_every, texts, s)
               for s in range(samples + 1)]
    T = batches[0]["input_ids"].shape[1]
    T_pad = -(-T // 128) * 128
    ev = se.StreamEvaluator(params, cfg)

    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    times, outs = [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(ev(b["input_ids"], b["labels"], b["frames"], 0.725))
        times.append(time.perf_counter() - t0)
    stream_counts = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    if stream_counts["K2f"] != lcfg.num_layers * len(batches):
        raise AssertionError(f"K2f launches {stream_counts['K2f']}, want "
                             f"{lcfg.num_layers} a sample")
    for out in outs:
        if out.shape != (4,) or not np.isfinite(out).all():
            raise AssertionError(f"bad metrics {out}")
    dt = float(np.median(times[1:]))
    log(f"8B eval (int8 base, bf16 LoRA r 128 and connector): {minutes:g}-min "
        f"live1+ video, {n_frames} frames, {n_turns} turns, T {T} (padded "
        f"to {T_pad}), threshold 0.725; first call {times[0]:.2f} s, then "
        f"{', '.join(f'{x:.3f}' for x in times[1:])} s: {dt:.3f} s/video, "
        f"{dt / n_turns * 1e3:.2f} ms/turn, {3600 / dt:,.0f} videos/hour; "
        f"peak memory {peak / 2**30:.2f} GiB; metrics [lm_ppl, frame_diff, "
        f"fluency, lm_correctness] {outs[-1].tolist()}; launches "
        f"{stream_counts} [{card}]")
    _profile_eval(lambda: ev(batches[1]["input_ids"], batches[1]["labels"],
                             batches[1]["frames"], 0.725),
                  "one 8B StreamEvaluator call (10-minute video)", card)

    # the rollforward branch on its own (data-dependent: random weights
    # fire the gate inside every turn), on a capacity-matched ring
    to_append = turn_every - 1
    per = cfg.frame_num_tokens + 1
    cache = llama.init_kv_cache(lcfg, 1, T + to_append * per, device="cuda")
    cache = llama.trim_kv_cache(cache, T)
    frames = batches[0]["frames"]
    ev._rollforward(cache, T - to_append * per, frames, n_frames - to_append,
                    to_append, 0.725)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        ev._rollforward(cache, T - to_append * per, frames,
                        n_frames - to_append, to_append, 0.725)
    dt_roll = (time.perf_counter() - t0) / 4
    log(f"rollforward ({to_append} frames, {to_append * per} tokens appended "
        f"onto a ring of {T} rows, the overwritten rows saved and put back): "
        f"{dt_roll * 1e3:.1f} ms a turn [{card}]")

    # the chunked lm_head of the stats over T_pad rows (int8 head: each
    # 2048-row chunk casts the whole head to bf16, ROADMAP Queue 2 K0)
    h = torch.randn(T_pad, lcfg.hidden_size, device="cuda").bfloat16()
    labels = torch.zeros(T_pad, dtype=torch.long, device="cuda")
    with torch.no_grad():
        head_ms = cuda_ms(lambda _: se._chunk_stats(
            params, cfg, h, cfg.frame_token_interval_id, labels), 3, 1)
        cast_ms = cuda_ms(lambda _: params["llama"]["lm_head"]["q8"].to(
            torch.bfloat16), 10, 2)
    log(f"chunked lm_head stats over {T_pad} rows "
        f"({-(-T_pad // se.LM_CHUNK)} chunks of {se.LM_CHUNK}): "
        f"{head_ms:.2f} ms, of which one cast of the int8 head to bf16 takes "
        f"{cast_ms:.3f} ms a chunk [{card}]")
    del h, labels, cache

    k2f = _eval_k2f(T_pad)
    log(f"K2f at the 8B eval prefill (B1 Hq32 Hkv8 T=S={T_pad} d128 bf16, "
        f"causal, the ring sliced from {T_pad + 990} slots): vs plain "
        f"{K2_TOL[torch.bfloat16]}: max {k2f['max_abs_err']:.3g}, rel "
        f"{k2f['rel']:.3g}; device ms per call: _prefill_attn "
        f"{k2f['ms']:.3f} (kernel {k2f['kernel_ms']:.3f}, contiguous copy "
        f"of the K/V slice {k2f['slice_copy_ms']:.3f}), plain "
        f"{k2f['plain_ms']:.1f}, sdpa {k2f['library_ms']:.3f}, bound "
        f"{k2f['bound_ms']:.3f} ({k2f['bound_by']}): "
        f"{100 * k2f['bound_ms'] / k2f['kernel_ms']:.1f}% of the bound "
        f"[{card}]")

    # one LTA beam search through K1 at B 5
    prompt, pframes = _lta_prompt(tok, cfg)
    searcher = generation.BeamSearcher(params, cfg, num_beams=5)
    step, ring = searcher._reorder_and_step, {}

    def kept(tokens, cache, parents):   # keeps the search's last ring
        out = step(tokens, cache, parents)
        ring["cache"] = out[1]
        return out
    searcher._reorder_and_step = kept
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seqs = searcher.search(prompt, pframes, max_new_tokens=beam_new,
                           num_return_sequences=5)
    dt_beam = time.perf_counter() - t0
    beam_counts = _read_launches()
    del searcher._reorder_and_step
    steps = max(len(s) for s in seqs)
    if beam_counts["K1"] < lcfg.num_layers * (steps - 1) or len(seqs) != 5:
        raise AssertionError(f"beam: {len(seqs)} sequences, {steps} steps, "
                             f"launches {beam_counts}")
    log(f"8B LTA beam search (5 beams at B 5, {beam_new} new tokens, cut "
        f"from the dataset's 512; prompt {prompt.shape[1]} tokens): "
        f"{dt_beam:.2f} s, {steps} steps, {dt_beam / steps * 1e3:.1f} ms a "
        f"step, K1 launches {beam_counts['K1']} [{card}]")
    cache = ring.pop("cache")
    k1, positions = _k1_beam_hold(cache, prompt.shape[1], lcfg.num_heads)
    log(f"K1 on the beam search's ring (B 5 Hq32 Hkv8 d128 bf16, capacity "
        f"{cache.capacity}, q_pos {positions}, layers 0 and "
        f"{lcfg.num_layers - 1}) vs plain "
        f"{K1_TOL[torch.bfloat16]}: {_readings(k1)}")
    _profile_eval(lambda: searcher.search(prompt, pframes, max_new_tokens=8,
                                          num_return_sequences=5),
                  "an 8B LTA beam search of 8 steps (5 beams)", card)
    del params, ev, searcher, cache
    torch.cuda.empty_cache()
    launches = {n: stream_counts[n] + beam_counts[n] for n in stream_counts}
    return {"launches": launches, "k2f": k2f, "k1_err": k1["max"],
            "s_per_video": dt}


# --------------------------------------------------------------- phase 20
# New tokens of the dataset-preparation decodes: the refinement's own 64
# (narration_refinement_job.make_llama_generate_fn's default), LiveChat
# synthesis cut from the job's 512 to keep the run short (random weights
# never end a response early)
PREP_REFINE_NEW, PREP_CHAT_NEW = 64, 96
# SigLIP-large features of the padded last batch against the same frames
# encoded in a batch of their own (bf16: another batch size may take other
# GEMM kernels; the bound is phase 17's DEMO_ENC_REL)
PREP_PAD_REL = DEMO_ENC_REL
PREP_ROWS = ["C picks up the knife from the table.", "C cuts the onion.",
             "C picks up the knife from the table."]


@contextlib.contextmanager
def _builder_returns(params, tok):
    """models.builder.build_model_and_tokenizer returns (params, tok,
    tok.cfg) while entered: the refinement decoder then runs on weights
    built here (random, from a seed; nothing is downloaded). Yields the
    list of each call's (args, is_training, keywords)."""
    from videollm_online_tpu_torch.models import builder
    make, calls = builder.build_model_and_tokenizer, []

    def build(args, is_training=True, **kw):
        calls.append((args, is_training, kw))
        return params, tok, tok.cfg
    builder.build_model_and_tokenizer = build
    try:
        yield calls
    finally:
        builder.build_model_and_tokenizer = make


def _narration_root(root, rows):
    """An Ego4D narration root (narration_stream_train.json) with a video
    for each pair of rows."""
    import os
    os.makedirs(root, exist_ok=True)
    anno = {f"vid{i // 2}": {"au1": [
        {"time": 2.0 * j + 1.0, "text": text}
        for j, text in enumerate(rows[i:i + 2])]}
        for i in range(0, len(rows), 2)}
    with open(os.path.join(root, "narration_stream_train.json"), "w") as f:
        json.dump(anno, f)
    return root


def _goalstep_root(root):
    """A GoalStep root of one video (goalstep_train.json: a goal and four
    steps) and its metadata (video_uid -> duration)."""
    import os
    os.makedirs(root, exist_ok=True)
    steps = ["take out the pan", "crack two eggs into a bowl",
             "whisk the eggs", "pour the eggs into the pan"]
    video = {"video_uid": "gs0", "start_time": 0.0, "end_time": 240.0,
             "goal_description": "make an omelette",
             "segments": [{"start_time": 60.0 * i + 2.0,
                           "end_time": 60.0 * i + 50.0,
                           "step_description": s, "segments": []}
                          for i, s in enumerate(steps)]}
    with open(os.path.join(root, "goalstep_train.json"), "w") as f:
        json.dump({"videos": [video]}, f)
    return {"gs0": {"duration": 240.0}}


def phase_small_prep():
    """Narration refinement on a small fp32 model (2 layers, d 128, so
    decode takes K1): make_llama_generate_fn's texts are the greedy ids of
    the refinement prompts through K1, decoded, and those ids equal the
    same prompts' ids through the plain attention."""
    from videollm_online_tpu_torch.core.config import (LlamaConfig,
                                                       tiny_live_config)
    from videollm_online_tpu_torch.data.preprocess import (
        narration_refinement_job as refine)
    from videollm_online_tpu_torch.eval import generation
    from videollm_online_tpu_torch.models import live, llama
    from videollm_online_tpu_torch.tokenizer.live_tokenizer import (
        LiveTokenizer)
    from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer
    cfg = tiny_live_config(lora=None, llama=LlamaConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128,
        dtype="float32"))
    tok = LiveTokenizer(ByteTokenizer(), cfg)
    cfg = tok.cfg
    params = live.init_params(torch.Generator(device="cuda").manual_seed(0),
                              cfg, device="cuda")
    with _builder_returns(params, tok) as calls:
        fn = refine.make_llama_generate_fn("", "", device="cuda")
    if len(calls) != 1 or calls[0][0].lora_r != 0 or calls[0][2] != {
            "device": "cuda"}:
        raise AssertionError(f"builder calls {calls}")
    counts = _all_launch_counters()
    rows = PREP_ROWS[:2]
    n0 = counts["K1"].launches
    texts = [fn(refine.REFINE_PROMPT.format(text=r)) for r in rows]
    n_k1 = counts["K1"].launches - n0
    lengths = []
    for row, text in zip(rows, texts):
        prompt = tok.apply_chat_template(
            [{"role": "user",
              "content": refine.REFINE_PROMPT.format(text=row)}],
            add_generation_prompt=True) + " ["
        ids = np.asarray([tok.encode(prompt)])
        k1, plain = (generation.greedy_from_embeds(
            params, cfg, ids, None, max_new_tokens=PREP_REFINE_NEW,
            attn_impl=attn) for attn in (None, llama._attention))
        if not np.array_equal(k1, plain) or tok.decode(
                k1[0], skip_special_tokens=True) != text:
            raise AssertionError(f"refinement of {row!r}: K1 ids "
                                 f"{k1.tolist()}, plain {plain.tolist()}, "
                                 f"text {text!r}")
        lengths.append((ids.shape[1], k1.shape[1]))
    if n_k1 < cfg.llama.num_layers * sum(n - 1 for _, n in lengths):
        raise AssertionError(f"K1 launches {n_k1} for {lengths}")
    log(f"small refinement (fp32, 2 layers, d 128; prompt, new tokens "
        f"{lengths}): make_llama_generate_fn's texts are its greedy ids "
        f"through K1 ({n_k1} launches), equal to the plain attention's; "
        f"first {texts[0][:40]!r}")


def _siglip_batch_flop(vcfg, frames):
    """Operations of frame_features on ``frames`` frames: the encoder's
    projections, MLPs and attention products, the patch embedding and the
    pooling head (2 per multiply-add)."""
    P = vcfg.grid_size ** 2
    D, F, L = vcfg.hidden_size, vcfg.intermediate_size, vcfg.num_layers
    layer = 2 * P * D * (4 * D + 2 * F) + 4 * P * P * D
    head = 4 * P * D * D + 4 * D * D + 4 * P * D + 4 * D * F
    return frames * (L * layer + 2 * P * 3 * vcfg.patch_size ** 2 * D
                     + head)


def phase_main_path_prep(n_videos: int = 2, n_frames: int = 300,
                         seed: int = 0):
    """The dataset-preparation jobs at full width: encode_job over
    ``n_videos`` synthetic 384 px .avi videos of ``n_frames`` frames
    (written by the port's write_avi; 300 frames make a full batch of 256
    and a padded one) with random SigLIP-large, bf16, at its batch of 256:
    the job's frames/s, the device's s a batch by CUDA events, its busy
    share and peak memory, the .npy files read back through the feature
    store, the padded batch's rows against the same frames encoded in a
    batch of their own, one batch profiled by kernel class; then narration
    refinement of PREP_ROWS (make_llama_generate_fn, 64 new tokens) and
    LiveChat synthesis of one conversation (PREP_CHAT_NEW new tokens, cut
    from 512) on the 8B int8 decoder (random, built on the card), every
    decode step through K1."""
    import os
    import shutil

    from videollm_online_tpu_torch.core.config import (LiveConfig,
                                                       LlamaConfig,
                                                       live1_plus_config)
    from videollm_online_tpu_torch.data import avi, feature_store
    from videollm_online_tpu_torch.data.livechat import generation as chat
    from videollm_online_tpu_torch.data.preprocess import encode_job
    from videollm_online_tpu_torch.data.preprocess import (
        narration_refinement_job as refine)
    from videollm_online_tpu_torch.models import live, quant, siglip
    from videollm_online_tpu_torch.tokenizer.live_tokenizer import (
        LiveTokenizer)
    from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer
    card = _card()
    out_dir = _out_dir("prep")
    videos = os.path.join(out_dir, "videos")
    os.makedirs(videos)
    for v in range(n_videos):
        avi.write_avi(os.path.join(videos, f"clip{v}.avi"),
                      _demo_frames(n_frames, 384, seed + v), fps=2.0)
    batches = n_videos * -(-n_frames // encode_job.ENCODE_BATCH)
    log(f"prep videos: {n_videos} x {n_frames} frames of 384 px, "
        f"{sum(os.path.getsize(os.path.join(videos, f)) for f in os.listdir(videos)) / 2**20:.0f} "
        f"MiB rawvideo .avi; {batches} batches of "
        f"{encode_job.ENCODE_BATCH}")

    def job():
        return encode_job.run(videos, device="cuda", overwrite=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dst = job()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    busy_us, prof_wall_us, _ = _device_us(job)
    files = sorted(os.listdir(dst))
    cfg = live1_plus_config()
    vcfg = cfg.vision
    want = (n_frames, cfg.frame_num_tokens, vcfg.hidden_size)
    feats = [np.load(os.path.join(dst, f)) for f in files]
    if len(files) != n_videos or any(
            f.shape != want or f.dtype != np.float16
            or not np.isfinite(f).all() for f in feats):
        raise AssertionError(f"encode_job wrote {files}: "
                             f"{[(f.shape, f.dtype) for f in feats]}")
    path = os.path.join(dst, files[0])
    back = feature_store.load_feature_range(path, range(250, 260))
    if feature_store.feature_len(path) != n_frames or not np.array_equal(
            back, feats[0][250:260]):
        raise AssertionError("the feature store reads other features")

    # the device's time a batch (CUDA events) and the padded batch's rows
    params = siglip.init_params(torch.Generator(device="cuda").manual_seed(0),
                                vcfg, device="cuda")
    frames = torch.from_numpy(np.ascontiguousarray(
        avi.read_avi(os.path.join(videos, "clip0.avi")).frames.transpose(
            0, 3, 1, 2))).cuda()
    full = frames[:encode_job.ENCODE_BATCH]
    batch_ms = cuda_ms(lambda i: encode_job.encode(params, full, cfg), 2, 1)
    tail = encode_job.encode(params, frames[encode_job.ENCODE_BATCH:],
                             cfg).float()
    job_tail = torch.from_numpy(
        feats[0][encode_job.ENCODE_BATCH:].astype(np.float32)).cuda()
    pad_rel = float((job_tail - tail).norm() / tail.norm())
    if not pad_rel <= PREP_PAD_REL:
        raise AssertionError(f"padded batch rows {pad_rel:.3e} from the "
                             f"same frames alone")
    flop = _siglip_batch_flop(vcfg, encode_job.ENCODE_BATCH)
    log(f"encode_job (SigLIP-large bf16, batch {encode_job.ENCODE_BATCH}, "
        f"{n_videos * n_frames} frames in {batches} batches, the last of "
        f"each video padded; the job's first run): {wall:.2f} s = "
        f"{n_videos * n_frames / wall:.1f} frames/s end to end (.avi decode "
        f"and resize on the host included), device busy "
        f"{busy_us / 1e6:.2f} s of a profiled run's {prof_wall_us / 1e6:.2f} "
        f"s ({100 * busy_us / prof_wall_us:.1f} %); peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    log(f"encode batch on the device (CUDA events): {batch_ms:.1f} ms a "
        f"batch of {encode_job.ENCODE_BATCH} = "
        f"{1e3 * encode_job.ENCODE_BATCH / batch_ms:.0f} frames/s; "
        f"{flop / 1e12:.1f} TFLOP a batch = "
        f"{flop / batch_ms / 1e9:.0f} TFLOP/s, bound "
        f"{1e3 * flop / BF16_FLOPS_PER_S:.1f} ms (operations at "
        f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16); padded batch's rows "
        f"vs the same {n_frames - encode_job.ENCODE_BATCH} frames alone: "
        f"relative norm {pad_rel:.3e} (bound {PREP_PAD_REL:.0e}) [{card}]")
    _profile_eval(lambda: encode_job.encode(params, full, cfg),
                  "one SigLIP-large batch of 256 (encode_job)", card)
    del params, frames, full, tail, job_tail
    shutil.rmtree(videos)
    torch.cuda.empty_cache()

    # refinement and LiveChat synthesis on the 8B int8 decoder
    lcfg = LlamaConfig(vocab_size=128256, hidden_size=4096,
                       intermediate_size=14336, num_layers=32, num_heads=32,
                       num_kv_heads=8, head_dim=128, dtype="bfloat16")
    tok = LiveTokenizer(ByteTokenizer(), LiveConfig(llama=lcfg, lora=None))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = {"llama": quant.random_quantized_llama_params(
                  gen, tok.cfg.llama, bits=8, device="cuda"),
              "connector": live.init_connector(gen, tok.cfg, device="cuda")}
    root = _narration_root(os.path.join(out_dir, "ego4d"), PREP_ROWS)
    with _builder_returns(params, tok):
        refine_fn = refine.make_llama_generate_fn("", "", device="cuda")
        chat_fn = refine.make_llama_generate_fn(
            "", "", max_new_tokens=PREP_CHAT_NEW, device="cuda")
    distinct = len(set(PREP_ROWS))
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refine.run(root, "train", refine_fn)
    torch.cuda.synchronize()
    dt_refine = time.perf_counter() - t0
    refine_counts = _read_launches()
    out = os.path.join(root, "refined_narration_stream_train")
    refined = {f: json.load(open(os.path.join(out, f)))
               for f in sorted(os.listdir(out))}
    texts = [n["text"] for v in refined.values() for s in v.values()
             for n in s]
    if len(texts) != len(PREP_ROWS) or refine_counts["K1"] < (
            lcfg.num_layers * distinct * (PREP_REFINE_NEW - 1)):
        raise AssertionError(f"refined {refined}, launches {refine_counts}")
    log(f"8B int8 narration refinement ({len(PREP_ROWS)} narrations, "
        f"{distinct} "
        f"distinct, greedy {PREP_REFINE_NEW} new tokens each): "
        f"{dt_refine:.2f} s = {dt_refine / distinct:.2f} s a narration, "
        f"{1e3 * dt_refine / (distinct * PREP_REFINE_NEW):.1f} ms/token, "
        f"K1 launches {refine_counts['K1']}; first {texts[0][:40]!r} "
        f"[{card}]")

    metadata = _goalstep_root(os.path.join(out_dir, "goalstep"))
    chat_out = os.path.join(out_dir, "goalstep_livechat.json")
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    annos = chat.synthesize(os.path.join(out_dir, "goalstep"), metadata,
                            chat_fn, num_conversations=1, out_path=chat_out)
    torch.cuda.synchronize()
    dt_chat = time.perf_counter() - t0
    chat_counts = _read_launches()
    with open(chat_out) as f:
        written = json.load(f)
    if written != annos or chat_counts["K1"] < (
            lcfg.num_layers * (PREP_CHAT_NEW - 1)):
        raise AssertionError(f"synthesize wrote {written}, launches "
                             f"{chat_counts}")
    log(f"8B int8 LiveChat synthesis (one GoalStep video, one conversation, "
        f"greedy {PREP_CHAT_NEW} new tokens, cut from the job's 512): "
        f"{dt_chat:.2f} s, {1e3 * dt_chat / PREP_CHAT_NEW:.1f} "
        f"ms/token, {len(annos)} dialogues parsed from random weights' "
        f"text, K1 launches {chat_counts['K1']} [{card}]")
    del params
    torch.cuda.empty_cache()
    return {"launches": {k: refine_counts[k] + chat_counts[k]
                         for k in refine_counts},
            "frames_per_s": n_videos * n_frames / wall,
            "batch_ms": batch_ms}


# --------------------------------------------------------------- phase 22
WEB_FRAMES, WEB_QUERY_EVERY, WEB_STREAMS = 24, 8, 8
WEB_QUERY = "What am I doing now?"


class _Recorded:
    """An engine seen through a StreamingPipeline: forwards every attribute
    and records, at each call, the last frame fed (under the pipeline's
    lock), so a sequential drive can replay the same interleaving."""

    def __init__(self, engine):
        self.__dict__["_engine"] = engine
        self.__dict__["fed"] = []

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def __call__(self):
        self.fed.append(self._engine.last_frame_idx)
        return self._engine()


def _web_args(**kw):
    """serve/web.py main's argument surface for serve/cli.py's builders."""
    import types
    return types.SimpleNamespace(**{
        "checkpoint": "", "vision_checkpoint": "", "tokenizer": "",
        "model_size": "8b", "dtype": "bfloat16", "with_vision": False,
        "kv_capacity": 8192, "kv_quant": "", "seed": 0, "stream_tokens": 0,
        "device": "", **kw})


def _http(base, path, payload=None):
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


@contextlib.contextmanager
def _serving(httpd):
    import threading
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)


def _web_feats(cfg, n, seed):
    """The features WebDemo.load draws for {"frames": n, "seed": seed}."""
    return np.random.RandomState(seed).randn(
        n, cfg.frame_num_tokens, cfg.vision_hidden_size).astype(np.float32)


def _percentiles(ms):
    return (f"p50 {np.percentile(ms, 50):.1f} ms, p99 "
            f"{np.percentile(ms, 99):.1f} ms over {len(ms)}")


def phase_main_path_web():
    """The serving apps at full width: serve/web.py's demo over the 8B int8
    LiveInferEngine built as its main builds it (serve/cli.py's
    build_engine; the main paths' 20-token responses and gate bias), on
    127.0.0.1, driven by an HTTP client through /load, /query and /step
    for WEB_FRAMES frames with a query every WEB_QUERY_EVERY: the
    transcript equal, byte for byte, to the same schedule on the same
    engine driven directly, /step latency percentiles, K1 launches; then
    serve_multi over a WEB_STREAMS-stream MultiStreamEngine (K3) with two
    sessions, each transcript equal to a fresh engine driven directly
    through the same polls; then
    StreamingPipeline over the single engine under a non-default CUDA
    stream, its events equal to a sequential drive of the same
    interleaving."""
    from videollm_online_tpu_torch.ops import decode_attention as da
    from videollm_online_tpu_torch.ops import paged_attention as pa
    from videollm_online_tpu_torch.serve import cli, web
    from videollm_online_tpu_torch.serve.multistream import (
        MultiStreamEngine)
    from videollm_online_tpu_torch.serve.pipeline import StreamingPipeline
    card = _card()
    da._kernel(), pa._kernel()   # built before any request is timed
    args = _web_args()
    with _cli_config(max_response_tokens=DEMO_RESPONSE_TOKENS,
                     gate_logit_bias=DEMO_GATE_BIAS):
        engine, cfg = cli.build_engine(args)
    params, tok = engine.params, engine.tokenizer
    fps = cfg.frame_fps
    times = [i / fps for i in range(WEB_FRAMES)]

    # one session over HTTP, then the same schedule on the engine itself
    httpd, demo = web.serve(engine, fps, port=0)
    steps_ms = []
    _zero_launches()
    with _serving(httpd) as base:
        _http(base, "/load", {"frames": WEB_FRAMES, "seed": 7})
        for i, t in enumerate(times):
            if i % WEB_QUERY_EVERY == 0:
                _http(base, "/query", {"text": WEB_QUERY, "time": t})
            t0 = time.perf_counter()
            _http(base, f"/step?time={t}")
            steps_ms.append(1e3 * (time.perf_counter() - t0))
        got = [(m["role"], m["text"]) for m in
               _http(base, "/history")["messages"]]
    single_counts = _read_launches()
    engine.reset()
    engine.load_video(_web_feats(cfg, WEB_FRAMES, 7))
    want = []
    for i, t in enumerate(times):
        if i % WEB_QUERY_EVERY == 0:
            engine.input_query_stream(WEB_QUERY, video_time=t)
        engine.input_video_stream(t)
        while True:
            q, r = engine()
            if r is None:
                break
            want += ([("user", q)] if q else []) + [("assistant", r)]
    n_resp = sum(r == "assistant" for r, _ in got)
    if got != want or n_resp < WEB_FRAMES // WEB_QUERY_EVERY or \
            single_counts["K1"] == 0:
        raise AssertionError(f"web transcript {got[:4]} ... vs direct "
                             f"{want[:4]} ...; launches {single_counts}")
    log(f"web demo (8B int8, serve(engine, fps, port=0) on 127.0.0.1): "
        f"{WEB_FRAMES} frames over HTTP, a query every {WEB_QUERY_EVERY}: "
        f"{n_resp} responses, transcript byte-equal to the engine driven "
        f"directly; /step {_percentiles(steps_ms)}; launches "
        f"{single_counts} [{card}]")
    log(f"web demo first response: {got[1][1]!r}")

    # two sessions over a WEB_STREAMS-stream engine, then the same polls
    def multi():
        return MultiStreamEngine(params, tok, cfg, num_streams=WEB_STREAMS,
                                 kv_capacity=2560, device="cuda")
    seeds = {"a": 7, "b": 9}
    ms = multi()
    httpd, mdemo = web.serve_multi(ms, fps, port=0)
    poll_ms = []
    _zero_launches()
    with _serving(httpd) as base:
        for sid, s in seeds.items():
            _http(base, "/load", {"sid": sid, "frames": WEB_FRAMES,
                                  "seed": s})
        for i, t in enumerate(times):
            for sid in seeds:
                if i % WEB_QUERY_EVERY == (sid == "b") * 4:
                    _http(base, "/query", {"sid": sid, "text": WEB_QUERY,
                                           "time": t})
                t0 = time.perf_counter()
                _http(base, f"/step?sid={sid}&time={t}")
                poll_ms.append(1e3 * (time.perf_counter() - t0))
        rounds = 0
        while ms.pending() and rounds < 256:
            for sid in seeds:
                _http(base, f"/step?sid={sid}&time={times[-1]}")
            rounds += 1
        got = {sid: [(m["role"], m["text"]) for m in
                     _http(base, "/close", {"sid": sid})["messages"]]
               for sid in seeds}
    multi_counts = _read_launches()
    ms = multi()
    slots = {"a": 0, "b": 1}
    feats = {sid: _web_feats(cfg, WEB_FRAMES, s) for sid, s in seeds.items()}
    fed = {sid: 0 for sid in seeds}
    want = {sid: [] for sid in seeds}

    def poll(sid, t):
        fidx = min(int(t * fps), WEB_FRAMES - 1)
        if fidx >= fed[sid]:
            ms.input_frames(slots[sid], fed[sid] / fps,
                            feats[sid][fed[sid]:fidx + 1])
            fed[sid] = fidx + 1
        for j, r in enumerate(ms.step()):
            if r is not None:
                sid_j = "a" if j == 0 else "b"
                want[sid_j] += ([("user", r[0])] if r[0] else []) + [
                    ("assistant", r[1])]
    for i, t in enumerate(times):
        for sid in seeds:
            if i % WEB_QUERY_EVERY == (sid == "b") * 4:
                ms.input_query(slots[sid], WEB_QUERY, video_time=t)
            poll(sid, t)
    for _ in range(rounds):
        for sid in seeds:
            poll(sid, times[-1])
    if got != want or multi_counts["K3"] == 0 or not all(
            any(r == "assistant" for r, _ in v) for v in got.values()):
        raise AssertionError(f"multi-session transcripts {got} vs direct "
                             f"{want}; launches {multi_counts}")
    log(f"multi-session web demo (serve_multi, 8B int8 MultiStreamEngine "
        f"of {WEB_STREAMS} streams, 2 sessions x {WEB_FRAMES} frames, a "
        f"query every {WEB_QUERY_EVERY}): "
        f"{ {k: sum(r == 'assistant' for r, _ in v) for k, v in got.items()} } "
        f"responses, transcripts byte-equal to the engine driven directly; "
        f"/step {_percentiles(poll_ms)}, {rounds} drain rounds; launches "
        f"{multi_counts} [{card}]")
    del ms
    torch.cuda.empty_cache()

    # the pipeline's producer thread under the caller's non-default stream
    n = WEB_FRAMES // 2
    queries = [(t, WEB_QUERY) for t in times[:n:WEB_QUERY_EVERY]]
    engine.reset()
    engine.load_video(_web_feats(cfg, n, 3))
    seen = _Recorded(engine)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    _zero_launches()
    t0 = time.perf_counter()
    with torch.cuda.stream(side):
        pipe = StreamingPipeline(seen)
        for t, q in queries:
            pipe.submit_query(q, video_time=t)
        pipe.start_video((n - 1) / fps)
        events = pipe.drain()
        pipe.stop()
    torch.cuda.synchronize()
    dt_pipe = time.perf_counter() - t0
    pipe_counts = _read_launches()
    engine.reset()
    engine.load_video(_web_feats(cfg, n, 3))
    for t, q in queries:
        engine.input_query_stream(q, video_time=t)
    want = []
    for idx in seen.fed:
        if idx > engine.last_frame_idx:
            engine.input_video_stream(idx / fps)
        q, r = engine()
        if r is not None:
            want.append((q, r))
    if events != want or len(events) < len(queries) or \
            pipe._producer.is_alive():
        raise AssertionError(f"pipeline events {events} vs sequential "
                             f"{want}")
    log(f"StreamingPipeline (8B int8, {n} frames, {len(queries)} queries, "
        f"the caller on a non-default stream): {len(events)} events equal "
        f"to a sequential drive of the same {len(seen.fed)} engine calls "
        f"(frames fed before each: {seen.fed[:8]}...); {dt_pipe:.2f} s, "
        f"launches {pipe_counts} [{card}]")
    del engine, params
    torch.cuda.empty_cache()
    return {"launches": {k: single_counts[k] + multi_counts[k]
                         + pipe_counts[k] for k in single_counts}}



# ------------------------------------------------------- phases 23 and 24
# Two ranks on the one card: each is a process spawned from this script
# that joins a torch.distributed group (parallel.mesh.initialize_distributed
# over a file store under build/chip_smoke/; the backend rule picks gloo,
# NCCL taking no two ranks of one card, and the collectives copy through
# pinned host buffers). What a rank measures is two ranks sharing one card,
# not a speed of tensor or sequence parallelism.
TP_WORLD = 2
# The first forward's logits (20 tokens on a fresh ring, 8B int8 and
# int4, bf16; and 20 tokens a stream on a fresh 8-stream paged pool, int8)
# under TP 2 against the single-rank forward, relative norm: the
# row-parallel products are two bf16 partial sums added in bf16 where the
# single rank rounds one fp32 sum, 64 times a forward.
TP_LOGIT_REL = 3e-2
# The bf16 transcripts under TP against the single rank's: the same
# responses in number and queries, at least this share of response bytes
# equal at the same position (tests/test_torch_engine.py's BF16_SHARE).
TP_BF16_SHARE = 0.8
# The sequence-parallel and fsdp losses against the single rank's, relative:
# Ulysses and K2 compute each head whole, the ring's blocks and the
# token-local matmuls on T/2 rows sum in another order.
SP_LOSS_REL = 2e-3
SP_SEQ = 4096          # phase 8's training length
# phase 15's traffic cut from 64 frames a stream to 16 under TP, for time
TP_MS_FRAMES = 16
# phase 15b's gate-bias-0 fire run of the 8 paged streams (one query at
# t = 0), frames a stream
TP_FIRE_FRAMES = 12


def _rank_main(fn, rank, world, store, args, out_path, timeout):
    """A spawned rank: join the group, run fn(rank, world, backend, *args)
    and pickle ("ok", result) or ("error", traceback) to out_path."""
    import pickle
    import traceback
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        from videollm_online_tpu_torch.parallel.mesh import (
            initialize_distributed)
        backend = initialize_distributed(f"file://{store}", world, rank,
                                         device="cuda", timeout_s=timeout)
        result = ("ok", fn(rank, world, backend, *args))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def _spawn_ranks(fn, *args, world=TP_WORLD, timeout=900):
    """fn(rank, world, backend, *args) in ``world`` processes spawned from
    this script, all on card 0; returns their results in rank order and
    fails if any rank fails or outlives ``timeout``."""
    import multiprocessing as mp
    import pathlib
    import pickle
    d = pathlib.Path(_out_dir(f"ranks_{fn.__name__}"))
    outs = [d / f"rank{r}.pkl" for r in range(world)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world, str(d / "store"), args, str(outs[r]), timeout))
        for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout + 60)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    for r, path in enumerate(outs):
        if not path.exists():
            raise AssertionError(f"rank {r} of {fn.__name__} ended without "
                                 f"a result (exit {procs[r].exitcode})")
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise AssertionError(f"rank {r} of {fn.__name__} failed:\n"
                                 f"{value}")
        results.append(value)
    return results


def _int8_stream(n_frames=64):
    """Phase 5's configuration, stream and ring: (cfg, tok, capacity,
    feats); its weights come from seed 0 on the card (``_int8_8b``)."""
    from videollm_online_tpu_torch.core.config import (LiveConfig,
                                                       LlamaConfig)
    from videollm_online_tpu_torch.tokenizer.live_tokenizer import (
        LiveTokenizer)
    from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer
    lcfg = LlamaConfig(vocab_size=128256, hidden_size=4096,
                       intermediate_size=14336, num_layers=32, num_heads=32,
                       num_kv_heads=8, head_dim=128, dtype="bfloat16")
    tok = LiveTokenizer(ByteTokenizer(), LiveConfig(llama=lcfg, lora=None))
    cfg = tok.cfg.replace(frame_token_interval_threshold=0.725,
                          max_response_tokens=20, gate_logit_bias=30.0)
    capacity = max(8192, (4 + cfg.frame_num_tokens) * (n_frames + 8)
                   + (n_frames // 8 + 2) * (256 + cfg.max_response_tokens)
                   + 2048)
    feats = np.random.RandomState(0).randn(
        n_frames, cfg.frame_num_tokens, cfg.vision_hidden_size
    ).astype(np.float32)
    return cfg, tok, capacity, feats


def _int8_8b(cfg):
    from videollm_online_tpu_torch.models import live, quant
    gen = torch.Generator(device="cuda").manual_seed(0)
    return {"llama": quant.random_quantized_llama_params(
                gen, cfg.llama, bits=8, device="cuda"),
            "connector": live.init_connector(gen, cfg, device="cuda")}


def _int4_cli_engine(*flags):
    """Phase 11's engine as serve/cli.py builds it (with ``flags`` added),
    with phase 5's gate and response length."""
    from videollm_online_tpu_torch.serve import cli
    args = cli.parse_args(["--video", "features", "--model_size", "8b",
                           "--quantize", "int4", "--spec_decode",
                           "--kv_capacity", "8192", "--seed", "0", *flags])
    engine, cfg = cli.build_engine(args)
    cfg = cfg.replace(frame_token_interval_threshold=0.725,
                      max_response_tokens=20, gate_logit_bias=30.0)
    engine.cfg, engine.max_new = cfg, 20
    return engine, cfg


def _ms_stream(n_frames=64):
    """Phase 15's traffic: (capacity, feats)."""
    cfg = _int8_stream()[0]
    fnt = cfg.frame_num_tokens
    capacity = 256 * ((n_frames * (fnt + 4) + 128 + (n_frames // 8 + 2)
                       * (128 + 20)) // 256 + 1)
    feats = np.random.RandomState(7).randn(
        n_frames, fnt, cfg.vision_hidden_size).astype(np.float32)
    return capacity, feats


def _first_logits(params, cfg, streams=0):
    """The logits of a 20-token prompt on a fresh ring (K1's route), or
    with ``streams`` > 0 of one such prompt a stream (each its own ids) on
    a fresh paged pool of one 512-slot page a stream (K3's route), fp32 on
    the host."""
    from videollm_online_tpu_torch.models import llama
    from videollm_online_tpu_torch.ops.auto import auto_attention
    if streams:
        cache = llama.init_paged_kv_cache(
            cfg.llama, streams, pool_pages=1 + streams, pages_per_stream=1,
            page_size=512, device="cuda")
        cache.table[:, 0] = 1 + torch.arange(streams, dtype=torch.int32)
        ids = 33 + torch.arange(20)[None] + 5 * torch.arange(streams)[:, None]
    else:
        cache = llama.init_kv_cache(cfg.llama, 1, 256, device="cuda")
        ids = (33 + torch.arange(20))[None]
    logits, _ = llama.forward(params["llama"], cfg=cfg.llama, input_ids=ids,
                              kv_cache=cache, attn_impl=auto_attention)
    return logits.float().cpu()


def _forward_reading(params, cfg, cache, attn_impl, S):
    """One S-token forward on the ring (its offset kept), after a warm-up:
    the collectives it made (calls and bytes by kind), its host wall and
    its device time under torch.profiler (us)."""
    from videollm_online_tpu_torch.models import llama
    from videollm_online_tpu_torch.parallel import collectives as coll
    emb = llama.embed_tokens(params["llama"],
                             torch.full((1, S), 33, dtype=torch.int32),
                             cfg.llama)

    def fwd():
        return llama.forward(params["llama"], cfg=cfg.llama,
                             inputs_embeds=emb, kv_cache=cache,
                             attn_impl=attn_impl, last_logit_only=True)

    fwd()
    coll.reset_stats()
    busy, wall, _ = _device_us(fwd)
    return {"calls": dict(coll.STATS["calls"]),
            "bytes": dict(coll.STATS["bytes"]), "wall_us": wall,
            "device_us": busy}


def _share_equal(got, want):
    """(equal, share of response bytes equal at the same position): the
    same responses in number and queries, then bytes compared."""
    if len(got) != len(want) or [q for q, _ in got] != [q for q, _ in want]:
        return False, 0.0
    same = sum(a == b for (_, g), (_, w) in zip(got, want)
               for a, b in zip(g, w))
    return got == want, same / max(sum(len(w) for _, w in want), 1)


def _tp_serving_rank(rank, world, backend):
    """Phase 23 on one rank: phase 5's, 11's and 15's engines on params
    cut ``tp`` over model=world, under the mesh; each rank-local kernel
    shape held against its plain version."""
    from videollm_online_tpu_torch.models import quant
    from videollm_online_tpu_torch.ops import fused_mlp as fm
    from videollm_online_tpu_torch.parallel.mesh import (make_mesh,
                                                         maybe_mesh)
    from videollm_online_tpu_torch.serve.engine import LiveInferEngine
    from videollm_online_tpu_torch.serve.multistream import MultiStreamEngine
    from videollm_online_tpu_torch.train.step import shard_params
    mesh = make_mesh(data=1, model=world, device="cuda")
    log(f"[rank {rank}] backend {backend}, {mesh}, host staging "
        f"{mesh.host_staging}")
    out = {"backend": backend, "staging": mesh.host_staging}
    gen = torch.Generator(device="cuda").manual_seed(100 + rank)

    # phase 5's stream on the 8B int8 engine
    cfg, tok, capacity, feats = _int8_stream()
    L = cfg.llama.num_layers
    params = shard_params(_int8_8b(cfg), mesh, "tp", cfg=cfg)
    torch.cuda.empty_cache()
    with maybe_mesh(mesh):
        logits = _first_logits(params, cfg)
        engine = LiveInferEngine(params, tok, cfg, kv_capacity=capacity,
                                 spec_decode=True, device="cuda")
        torch.cuda.synchronize()
        _zero_launches()
        t0 = time.perf_counter()
        transcript = _drive(engine, feats, 8, 8, cfg.frame_fps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _read_launches()
        readings = {S: _forward_reading(params, cfg, engine.cache,
                                        engine.attn_impl, S)
                    for S in (1, 20)}
        cache = engine.cache
        hq = cfg.llama.num_heads // world
        k1 = _worst([_k1_case(cache.k, cache.v, layer,
                              engine._host_offset - 20, S, gen=gen, Hq=hq)
                     for layer in (0, L - 1) for S in (1, 20)])
    out["int8"] = {"logits": logits, "transcript": transcript,
                   "fps": len(feats) / dt, "launches": counts,
                   "forward": readings, "k1": k1,
                   "kv_heads": int(cache.k.shape[2]),
                   "param_gib": quant.param_bytes(params) / 2**30}
    log(f"[rank {rank}] TP int8 engine: {len(feats) / dt:.3f} frames/s, "
        f"{len(transcript)} responses, launches {counts}; K1 at Hq {hq} / "
        f"Hkv {int(cache.k.shape[2])} vs plain: {_readings(k1)}")
    del engine, params, cache
    torch.cuda.empty_cache()

    # phase 11's int4 engine, built by serve/cli.py and cut
    whole, cfg4 = _int4_cli_engine()
    params = shard_params(whole.params, mesh, "tp", cfg=cfg4)
    tok4 = whole.tokenizer
    del whole
    torch.cuda.empty_cache()
    with maybe_mesh(mesh):
        logits4 = _first_logits(params, cfg4)
        engine = LiveInferEngine(params, tok4, cfg4, kv_capacity=8192,
                                 spec_decode=True, device="cuda")
        torch.cuda.synchronize()
        _zero_launches()
        t0 = time.perf_counter()
        transcript = _drive(engine, feats, 8, 8, cfg4.frame_fps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _read_launches()
        per_fwd = _count_forward(params, cfg4, engine.cache,
                                 engine.attn_impl, 20)
    lp = params["llama"]["layers"]
    mats = [lp[n][k][0] for n in ("w_gate", "w_up", "w_down")
            for k in ("q4c", "scale")]
    head = params["llama"]["lm_head"]
    errs = {}
    for rows in (1, 20):
        x = torch.randn((rows, cfg4.llama.hidden_size), generator=gen,
                        device="cuda").to(torch.bfloat16)
        errs[f"K4 {rows}"] = _fused_case("K4", x, mats, "mlp_bf16",
                                         f"TP rank-local {rows} rows")
        errs[f"K5 {rows}"] = _fused_case("K5", x, [head["q4c"],
                                                   head["scale"]],
                                         "matmul",
                                         f"TP rank-local {rows} rows")
    F_local = mats[0].shape[1] * 2
    V_local = head["q4c"].shape[1] * 2
    out["int4"] = {"logits": logits4, "transcript": transcript,
                   "fps": len(feats) / dt,
                   "launches": counts, "per_forward": per_fwd,
                   "errs": errs, "F": F_local, "V": V_local,
                   "fused_shapes_taken": fm._layer_takes(
                       "q4c", [lp[n] for n in ("w_gate", "w_up",
                                               "w_down")])}
    log(f"[rank {rank}] TP int4 engine: {len(feats) / dt:.3f} frames/s, "
        f"{len(transcript)} responses, launches {counts}, a 20-token "
        f"forward {per_fwd}; K4 at D {cfg4.llama.hidden_size} x F "
        f"{F_local} and K5 at V {V_local} vs plain: "
        + "; ".join(f"{k} {_readings(v)}" for k, v in errs.items()))
    del engine, params
    torch.cuda.empty_cache()

    # phase 15's traffic on the 8-stream paged engine, TP_MS_FRAMES a stream
    capacity, ms_feats = _ms_stream(TP_MS_FRAMES)
    params = shard_params(_int8_8b(cfg), mesh, "tp", cfg=cfg)
    torch.cuda.empty_cache()
    with maybe_mesh(mesh):
        paged_logits = _first_logits(params, cfg, streams=8)
        ms = MultiStreamEngine(params, tok, cfg, num_streams=8,
                               kv_capacity=capacity, device="cuda")
        dt, ms_out, ticks, fwds, counts = _ms_run(ms, ms_feats, 8)
        c = ms.cache
        offsets = [int(o) - 21 for o in c.offset]
        k3 = _worst([_k3_case(f"TP rank-local S {S} layer {layer}",
                              (c.k, c.v, None, None), c.table.cuda(),
                              _k3_qpos(offsets, S), layer, Hq=hq,
                              dtype=torch.bfloat16, gen=gen)
                     for layer in (0, L - 1) for S in (1, 20)])
        # the same streams through the pipelined tick (depth 2). No
        # set_sync_debug_mode check here (phase 15b's): under this mesh
        # every all-reduce goes through pinned host buffers and makes the
        # host wait, so a fill cannot be free of host synchronisation
        ms.pipelined = True
        p_dt, p_out, p_ticks, p_fwds, p_counts = _ms_run(ms, ms_feats, 8)
        pipe = {"transcripts": p_out, "fps": 8 * len(ms_feats) / p_dt,
                "ticks": p_ticks, "forwards": p_fwds, "launches": p_counts,
                "counts": ms.dispatch_stats()}
        # phase 15b's fire run: the gate bias removed and one query at
        # t = 0, so ticks go out behind ticks in flight and streams whose
        # gate fires roll back; each rank must take the same decisions
        ms.cfg = cfg.replace(gate_logit_bias=0.0)
        f_dt, f_out, f_ticks, f_fwds, f_counts = _ms_run(
            ms, ms_feats[:TP_FIRE_FRAMES], TP_FIRE_FRAMES)
        fire = {"transcripts": f_out, "ticks": f_ticks, "forwards": f_fwds,
                "launches": f_counts, "counts": ms.dispatch_stats()}
    out["multistream"] = {"logits": paged_logits, "transcripts": ms_out,
                          "fps": 8 * len(ms_feats) / dt, "ticks": ticks,
                          "forwards": fwds, "launches": counts, "k3": k3,
                          "kv_heads": int(c.k.shape[2]), "pipelined": pipe,
                          "fire": fire}
    log(f"[rank {rank}] TP multistream (8 streams, paged): "
        f"{8 * len(ms_feats) / dt:.3f} frames/s aggregate, {ticks} ticks, "
        f"{fwds} forwards, launches {counts}; K3 at Hq {hq} / Hkv "
        f"{int(c.k.shape[2])} vs plain: {_readings(k3)}")
    log(f"[rank {rank}] TP multistream pipelined: {pipe['fps']:.3f} frames/s "
        f"aggregate, {p_ticks} ticks, {p_fwds} forwards, launches "
        f"{p_counts}, dispatch counts {pipe['counts']}")
    log(f"[rank {rank}] TP multistream pipelined, gate bias 0: {f_ticks} "
        f"ticks, {f_fwds} forwards, launches {f_counts}, dispatch counts "
        f"{fire['counts']}")
    del ms, params, c
    torch.cuda.empty_cache()
    return out


def phase_tp_serving():
    """Phase 23: tensor-parallel serving at full width on two ranks of the
    card, each holding its ``shard_params(..., "tp")`` tree under
    ``maybe_mesh``: phase 5's int8 stream, phase 11's int4 stream (K4 at
    a local F of 7168, K5 at a local vocabulary of 64128) and phase 15's 8
    paged streams cut to TP_MS_FRAMES frames each (K3 at 16 q / 4 kv
    heads), blocking and then pipelined (the pipelined transcripts equal
    to one rank's pipelined run, byte for byte, on both ranks), then
    pipelined at gate bias 0 with one query at t = 0 (both ranks' the same
    transcripts and dispatch counts, two ticks in flight, some rolled
    back, the transcripts equal to one rank's pipelined run), each
    against the single-rank engine on the same full weights (no warm-up:
    what the ranks time is two processes sharing one card)."""
    from videollm_online_tpu_torch.serve.multistream import MultiStreamEngine
    card = _card()
    cfg, tok, capacity, feats = _int8_stream()
    params = _int8_8b(cfg)
    ref_logits = {"int8": _first_logits(params, cfg),
                  "paged": _first_logits(params, cfg, streams=8)}
    if "int8" not in _SINGLE_RANK:
        from videollm_online_tpu_torch.serve.engine import LiveInferEngine
        _SINGLE_RANK["int8"] = _drive(LiveInferEngine(
            params, tok, cfg, kv_capacity=capacity, spec_decode=True,
            device="cuda"), feats, 8, 8, cfg.frame_fps)
    ms_capacity, ms_feats = _ms_stream(TP_MS_FRAMES)
    ms = MultiStreamEngine(params, tok, cfg, num_streams=8,
                           kv_capacity=ms_capacity, device="cuda")
    ms_ref = _ms_run(ms, ms_feats, 8)[1]
    ms.pipelined = True
    pipe_ref = _ms_run(ms, ms_feats, 8)[1]
    ms.cfg = cfg.replace(gate_logit_bias=0.0)
    fire_ref = _ms_run(ms, ms_feats[:TP_FIRE_FRAMES], TP_FIRE_FRAMES)[1]
    fire_ref_counts = ms.dispatch_stats()
    del ms
    del params
    torch.cuda.empty_cache()
    if "int4_logits" not in _SINGLE_RANK:
        engine, cfg4 = _int4_cli_engine()
        _SINGLE_RANK["int4"] = _drive(engine, feats, 8, 8, cfg4.frame_fps)
        _SINGLE_RANK["int4_logits"] = _first_logits(engine.params, cfg4)
        del engine
        torch.cuda.empty_cache()
    ref_logits["int4"] = _SINGLE_RANK["int4_logits"]

    t0 = time.perf_counter()
    ranks = _spawn_ranks(_tp_serving_rank)
    log(f"two ranks, spawned, built and driven in "
        f"{time.perf_counter() - t0:.1f} s")
    launches = {k: 0 for k in ("K1", "K3", "K4", "K5")}
    errs = {"K1": 0.0, "K3": 0.0, "K4": 0.0, "K5": 0.0}
    L = cfg.llama.num_layers
    for rank, r in enumerate(ranks):
        i8, i4, ms = r["int8"], r["int4"], r["multistream"]
        rel = {name: float((got["logits"] - ref_logits[name]).norm()
                           / ref_logits[name].norm())
               for name, got in (("int8", i8), ("int4", i4),
                                 ("paged", ms))}
        if max(rel.values()) > TP_LOGIT_REL:
            raise AssertionError(f"rank {rank}: TP logits rel {rel}")
        rel_s = ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
        shares = {}
        for name, got, want in (
                ("int8", i8["transcript"], _SINGLE_RANK["int8"]),
                ("int4", i4["transcript"], _SINGLE_RANK["int4"])):
            equal, share = _share_equal(got, want)
            if share < TP_BF16_SHARE:
                raise AssertionError(f"rank {rank} {name}: transcript share "
                                     f"{share:.3f}\n{got}\n{want}")
            shares[name] = (equal, share)
        ms_shares = [_share_equal(g, w) for g, w in zip(
            ms["transcripts"], ms_ref)]
        if min(s for _, s in ms_shares) < TP_BF16_SHARE:
            raise AssertionError(f"rank {rank} multistream: shares "
                                 f"{ms_shares}")
        pipe = ms["pipelined"]
        if pipe["transcripts"] != pipe_ref or \
                pipe["transcripts"] != ranks[0]["multistream"]["pipelined"][
                    "transcripts"]:
            raise AssertionError(f"rank {rank} pipelined multistream: "
                                 f"{pipe['transcripts']} != one rank's "
                                 f"{pipe_ref}")
        if pipe["launches"]["K3"] != L * pipe["forwards"]:
            raise AssertionError(f"rank {rank} pipelined: K3 "
                                 f"{pipe['launches']['K3']} for "
                                 f"{pipe['forwards']} forwards")
        pc = pipe["counts"]
        log(f"  pipelined 8 streams x {TP_MS_FRAMES}: transcripts equal one "
            f"rank's pipelined run and the other rank's; {pipe['fps']:.3f} "
            f"frames/s aggregate (two ranks sharing one card), "
            f"{pc['dispatches']} dispatches, {pc['rolled_back']} rolled back "
            f"({pc['rolled_back_frames']} frames), at most "
            f"{pc['max_inflight']} in flight, host wait at resolution "
            f"{1e3 * pc['wait_s']:.2f} ms over {pc['resolved']} "
            f"resolutions; no sync-free check (gloo's host-staged "
            f"collectives make the host wait)")
        fire, fc = ms["fire"], ms["fire"]["counts"]
        f_equal = fire["transcripts"] == fire_ref
        if fire["transcripts"] != ranks[0]["multistream"]["fire"][
                "transcripts"] or not f_equal:
            raise AssertionError(f"rank {rank} pipelined fire run: "
                                 f"{fire['transcripts']} against rank 0's "
                                 f"and one rank's {fire_ref}")
        if fc["max_inflight"] < 2 or not fc["rolled_back"] or \
                fc != ranks[0]["multistream"]["fire"]["counts"] | {
                    "wait_s": fc["wait_s"]}:
            raise AssertionError(f"rank {rank} pipelined fire run: counts "
                                 f"{fc} (rank 0 "
                                 f"{ranks[0]['multistream']['fire']['counts']}"
                                 f"): needs two ticks in flight, a rollback "
                                 f"and rank 0's decisions")
        if fire["launches"]["K3"] != L * fire["forwards"]:
            raise AssertionError(f"rank {rank} pipelined fire run: K3 "
                                 f"{fire['launches']['K3']} for "
                                 f"{fire['forwards']} forwards")
        log(f"  pipelined 8 streams x {TP_FIRE_FRAMES}, gate bias 0, one "
            f"query at t = 0: transcripts equal one rank's pipelined run "
            f"and the other rank's; "
            f"{fc['dispatches']} dispatches, {fc['rolled_back']} stream "
            f"shares rolled back ({fc['rolled_back_frames']} frames), at "
            f"most {fc['max_inflight']} in flight, host wait at resolution "
            f"{1e3 * fc['wait_s']:.2f} ms over {fc['resolved']} "
            f"resolutions (one rank: {fire_ref_counts['dispatches']} "
            f"dispatches, {fire_ref_counts['rolled_back']} rolled back)")
        if min(i8["launches"]["K1"], i4["launches"]["K4"],
               i4["launches"]["K5"], ms["launches"]["K3"]) == 0 or \
                ms["launches"]["K3"] != L * ms["forwards"] or \
                (i4["per_forward"]["K4"], i4["per_forward"]["K5"]) != (L, 1):
            raise AssertionError(f"rank {rank}: launches {i8['launches']}, "
                                 f"{i4['launches']}, {ms['launches']}, a "
                                 f"20-token int4 forward {i4['per_forward']}")
        for k in launches:
            launches[k] += (i8["launches"][k] + i4["launches"][k]
                            + ms["launches"][k]
                            + ms["pipelined"]["launches"][k]
                            + ms["fire"]["launches"][k])
        errs["K1"] = max(errs["K1"], i8["k1"]["max"])
        errs["K3"] = max(errs["K3"], ms["k3"]["max"])
        for k, v in i4["errs"].items():
            errs[k[:2]] = max(errs[k[:2]], v["max"])
        log(f"rank {rank} ({r['backend']}, host staging {r['staging']}): "
            f"first-forward logits rel {rel_s} (bound {TP_LOGIT_REL}); "
            f"transcripts (equal, share of bytes) int8 {shares['int8']}, "
            f"int4 {shares['int4']}, multistream "
            f"{[(e, round(s, 3)) for e, s in ms_shares]}; parameters "
            f"{i8['param_gib']:.2f} GiB, ring kv heads {i8['kv_heads']}")
        log(f"  frames/s with two ranks sharing one card (not a speed of "
            f"TP): int8 {i8['fps']:.3f}, int4 {i4['fps']:.3f}, 8 streams "
            f"{ms['fps']:.3f} aggregate; K1 {i8['launches']['K1']}, K4 "
            f"{i4['launches']['K4']}, K5 {i4['launches']['K5']}, K3 "
            f"{ms['launches']['K3']} launches")
        for S, f in i8["forward"].items():
            log(f"  a {S}-token int8 forward: collectives {f['calls']}, "
                f"bytes {f['bytes']}; wall {f['wall_us'] / 1e3:.2f} ms "
                f"against {f['device_us'] / 1e3:.2f} ms on the device (two "
                f"ranks sharing one card)")
    log(f"phase 23 launches over both ranks {launches}; rank-local kernels "
        f"vs plain, max abs error {errs} [{card}]")
    return {"launches": launches, "errs": errs}


def _sp_training_rank(rank, world, backend, steps):
    """Phase 24 on one rank: phase 8's step under sp_ulysses over
    model=world, then at 4 layers sp_ring, fsdp_tp over data=world, and
    evaluate_entry across the ranks."""
    import dataclasses
    import tempfile
    from videollm_online_tpu_torch.evaluate_entry import evaluate
    from videollm_online_tpu_torch.ops.auto import auto_attention
    from videollm_online_tpu_torch.parallel import collectives as coll
    from videollm_online_tpu_torch.parallel.mesh import make_mesh
    out = {"backend": backend}
    gen = torch.Generator(device="cuda").manual_seed(200 + rank)
    cfg, tok = _train_config()
    batch, _ = synthetic_batch(cfg, SP_SEQ, np.random.RandomState(0))
    model_axis = ["--mesh_model_axis", str(world)]
    for name, layers, attn, mesh_kw in (
            ("sp_ulysses", None, "sp_ulysses", None),
            ("sp_ring", 4, "sp_ring", None),
            ("fsdp_tp", 4, auto_attention, {"data": world, "model": 1})):
        c = cfg if layers is None else cfg.replace(
            llama=dataclasses.replace(cfg.llama, num_layers=layers))
        b = batch if mesh_kw is None else _two_samples(c)
        n = steps if layers is None else 2
        params = _lora_8b_params(
            c, torch.Generator(device="cuda").manual_seed(0))
        out_dir = _out_dir(f"{name}_rank{rank}")
        mesh = None if mesh_kw is None else make_mesh(device="cuda",
                                                      **mesh_kw)
        trainer = _trainer(params, c, tok, out_dir, b, n, attn,
                           extra=model_axis if mesh is None else (),
                           mesh=mesh)
        del params
        torch.cuda.empty_cache()
        step_ms = []
        inner = trainer._step

        def timed(*a, inner=inner, step_ms=step_ms):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = inner(*a)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return r

        trainer._step = timed
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        coll.reset_stats()
        trainer.train()
        torch.cuda.synchronize()
        res = {"launches": _read_launches(), "step_ms": step_ms,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "collectives": {k: (coll.STATS["calls"][k] / n,
                                   coll.STATS["bytes"][k] / n)
                               for k in coll.STATS["calls"]},
               "steps": n, "layers": c.llama.num_layers,
               "mesh": repr(trainer.mesh)}
        if rank == 0:
            res["losses"] = [r["loss"] for r in _logged(out_dir)]
        out[name] = res
        log(f"[rank {rank}] {name} ({res['mesh']}, {c.llama.num_layers} "
            f"layers, batch {tuple(b['input_ids'].shape)}): ms a step "
            f"{[round(t, 1) for t in step_ms]}, peak "
            f"{res['peak_gib']:.2f} GiB, launches {res['launches']}")
        del trainer
        torch.cuda.empty_cache()
        if name == "sp_ulysses":
            # K2's three kernels at Ulysses's rank-local shapes: the heads
            # of this rank after the all-to-all, GQA expanded
            hq = cfg.llama.num_heads // world
            d = cfg.llama.head_dim
            out["k2"], _ = _k2_case(f"Ulysses rank-local (1, {hq}, "
                                    f"{SP_SEQ}, {d})", 1, hq, hq, SP_SEQ,
                                    SP_SEQ, d, torch.bfloat16, gen)
    with tempfile.TemporaryDirectory() as tmp, \
            _coin_eval(tmp, EVAL_COIN_NEW):
        t0 = time.perf_counter()
        out["coin_eval"] = evaluate([
            "--live_version", "live1+", "--model_size", "1b",
            "--eval_datasets", "coin_step_test", "--pad_to_multiple", "16",
            "--output_dir", tmp + "/out"])
        out["coin_eval_s"] = time.perf_counter() - t0
    return out


def _two_samples(cfg):
    """A batch of two synthetic samples (seeds 0 and 1) at T SP_SEQ."""
    a, _ = synthetic_batch(cfg, SP_SEQ, np.random.RandomState(0))
    b, _ = synthetic_batch(cfg, SP_SEQ, np.random.RandomState(1))
    out = {k: np.concatenate([a[k], b[k]]) for k in a if k != "frames"}
    if "frames" in a:
        out["frames"] = np.concatenate([a["frames"], b["frames"]])
    return out


def _single_losses(cfg, tok, batch, layers, steps):
    """The single-rank LiveTrainer's logged losses (auto attention)."""
    import dataclasses
    from videollm_online_tpu_torch.ops.auto import auto_attention
    c = cfg.replace(llama=dataclasses.replace(cfg.llama, num_layers=layers))
    params = _lora_8b_params(c, torch.Generator(device="cuda").manual_seed(0))
    out_dir = _out_dir(f"single_{layers}_{batch['input_ids'].shape[0]}")
    trainer = _trainer(params, c, tok, out_dir, batch, steps, auto_attention)
    del params
    trainer.train()
    del trainer
    torch.cuda.empty_cache()
    return [r["loss"] for r in _logged(out_dir)]


def phase_sp_training(steps: int = 3):
    """Phase 24: sharded training on two ranks of the card: phase 8's 8B
    int8 LoRA step (T 4096, r 128, dropout 0.05) under ``mesh_model_axis
    2`` and ``sp_ulysses`` (K2f, K2b, K2q on each rank's 16 heads; the
    base whole along the model axis, which carries the sequence), its
    first ``steps`` steps (phase 8 takes 4, cut for time), then
    at 4 layers ``sp_ring`` and ``fsdp_tp`` over data 2 (a batch of two
    split over it), and ``evaluate_entry`` (1B proxy, synthetic COIN)
    striped over the two ranks; each against its single-rank run."""
    import tempfile
    card = _card()
    cfg, tok = _train_config()
    batch, _ = synthetic_batch(cfg, SP_SEQ, np.random.RandomState(0))
    if "train_8b" not in _SINGLE_RANK:
        _SINGLE_RANK["train_8b"] = _single_losses(
            cfg, tok, batch, cfg.llama.num_layers, steps)
    want = {"sp_ulysses": _SINGLE_RANK["train_8b"][:steps],
            "sp_ring": _single_losses(cfg, tok, batch, 4, 2),
            "fsdp_tp": _single_losses(cfg, tok, _two_samples(cfg), 4, 2)}
    if "coin_eval" not in _SINGLE_RANK:
        from videollm_online_tpu_torch.evaluate_entry import evaluate
        with tempfile.TemporaryDirectory() as tmp, \
                _coin_eval(tmp, EVAL_COIN_NEW):
            _SINGLE_RANK["coin_eval"] = evaluate([
                "--live_version", "live1+", "--model_size", "1b",
                "--eval_datasets", "coin_step_test", "--pad_to_multiple",
                "16", "--output_dir", tmp + "/out"])
    t0 = time.perf_counter()
    ranks = _spawn_ranks(_sp_training_rank, steps)
    log(f"two ranks, spawned and trained in {time.perf_counter() - t0:.1f} s")
    L = cfg.llama.num_layers
    launches = {k: 0 for k in ("K2f", "K2b", "K2q")}
    for name, w in want.items():
        got = ranks[0][name]["losses"]
        rel = [abs(a - b) / max(abs(b), 1e-9) for a, b in zip(got, w)]
        if len(got) != len(w) or max(rel) > SP_LOSS_REL:
            raise AssertionError(f"{name}: losses {got} vs single {w}")
        log(f"{name}: losses {[round(x, 5) for x in got]} vs the single "
            f"rank's {[round(x, 5) for x in w]}, rel "
            f"{[float(f'{x:.3g}') for x in rel]} (bound {SP_LOSS_REL})")
    for rank, r in enumerate(ranks):
        u = r["sp_ulysses"]
        per_step = {k: u["launches"][k] / u["steps"]
                    for k in ("K2f", "K2b", "K2q")}
        if per_step != {"K2f": 2 * L, "K2b": L, "K2q": L}:
            raise AssertionError(f"rank {rank}: K2 launches a step "
                                 f"{per_step}")
        for k in launches:
            launches[k] += u["launches"][k]
        if r["coin_eval"] != _SINGLE_RANK["coin_eval"]:
            raise AssertionError(f"rank {rank}: evaluate over two ranks "
                                 f"{r['coin_eval']} vs one "
                                 f"{_SINGLE_RANK['coin_eval']}")
        log(f"rank {rank} ({r['backend']}): sp_ulysses K2 launches a step "
            f"{per_step}; ms a step (two ranks sharing one card, not a "
            f"speed of SP) " + "; ".join(
                f"{n} {[round(t, 1) for t in r[n]['step_ms']]}"
                for n in want) + "; peak GiB " + ", ".join(
                f"{n} {r[n]['peak_gib']:.2f}" for n in want))
        log(f"  collectives a step (calls, bytes): " + "; ".join(
            f"{n} {r[n]['collectives']}" for n in want))
        log(f"  evaluate_entry over two ranks: {r['coin_eval']} in "
            f"{r['coin_eval_s']:.1f} s, equal to one process's")
    errs = {"K2f": max(r["k2"]["fwd"] for r in ranks),
            "K2b": max(r["k2"]["dkdv"] for r in ranks),
            "K2q": max(r["k2"]["dq"] for r in ranks)}
    log(f"phase 24 launches over both ranks {launches}; K2 at the "
        f"rank-local shapes vs plain, max abs error {errs} [{card}]")
    return {"launches": launches, "errs": errs}



def _nccl_shared_card_rank(rank, world, store, out_path):
    """One rank of an NCCL group whose ranks share card 0: init and one
    all-reduce, or the error that refuses them."""
    import datetime
    import pickle
    import torch.distributed as dist
    try:
        dist.init_process_group(
            "nccl", init_method=f"file://{store}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=60))
        x = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        result = f"ok: {x.tolist()}"
        dist.destroy_process_group()
    except Exception as e:  # the probe reports what refused the group
        result = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def _gloo_direct_rank(rank, world, backend, op):
    """One collective on a CUDA tensor handed to gloo as it is: "ok", or
    the error it raises (a crash of the process shows as no result)."""
    import torch.distributed as dist
    x = torch.full((4,), float(rank + 1), device="cuda")
    fns = {"all_reduce": lambda: dist.all_reduce(x.clone()),
           "broadcast": lambda: dist.broadcast(x.clone(), 0),
           "all_gather": lambda: dist.all_gather(
               [torch.empty_like(x) for _ in range(world)], x),
           "all_to_all_single": lambda: dist.all_to_all_single(
               torch.empty_like(x), x),
           "send/recv": lambda: dist.send(x, 1) if rank == 0
           else dist.recv(torch.empty_like(x), 0)}
    try:
        fns[op]()
        torch.cuda.synchronize()
        return "ok"
    except Exception as e:  # the probe reports what gloo refuses
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def _gloo_staged_rank(rank, world, backend):
    """Each kind through parallel/collectives.py (pinned host buffers) on
    CUDA tensors; the results, checked by the caller."""
    from videollm_online_tpu_torch.parallel import collectives as coll
    from videollm_online_tpu_torch.parallel.mesh import MODEL_AXIS, make_mesh
    mesh = make_mesh(data=1, model=world, device="cuda")
    y = (rank * 10 + torch.arange(world * 2, device="cuda",
                                  dtype=torch.float32))
    return {"backend": backend, "staging": mesh.host_staging, "staged": {
        "all_reduce": coll.all_reduce(y, mesh, MODEL_AXIS).tolist(),
        "all_gather": coll.all_gather(y, mesh, MODEL_AXIS, 0).tolist(),
        "all_to_all": coll.all_to_all(y, mesh, MODEL_AXIS, 0, 0).tolist(),
        "ring_shift": coll.ring_shift(y, mesh, MODEL_AXIS).tolist()}}


def phase_collective_probe():
    """Which backend carries which collective for ranks that share the
    card: an NCCL group of two ranks on card 0 (expected refused), gloo
    handed CUDA tensors directly (each collective in a world of its own:
    some abort the process), and gloo through the collectives module's
    pinned host buffers (the rule parallel/mesh.py follows)."""
    import multiprocessing as mp
    import pathlib
    import pickle
    d = pathlib.Path(_out_dir("nccl_probe"))
    ctx = mp.get_context("spawn")
    outs = [d / f"rank{r}.pkl" for r in range(TP_WORLD)]
    procs = [ctx.Process(target=_nccl_shared_card_rank, args=(
        r, TP_WORLD, str(d / "store"), str(outs[r])))
        for r in range(TP_WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    nccl = []
    for p, path in zip(procs, outs):
        if p.is_alive():
            p.kill()
            p.join()
            nccl.append("did not finish in 120 s")
        else:
            nccl.append(pickle.load(open(path, "rb")) if path.exists()
                        else f"exit {p.exitcode}, no result")
    log(f"NCCL, {TP_WORLD} ranks on one card: {nccl}")
    direct = {}
    for op in ("all_reduce", "broadcast", "all_gather", "all_to_all_single",
               "send/recv"):
        try:
            direct[op] = _spawn_ranks(_gloo_direct_rank, op, timeout=60)
        except AssertionError as e:   # a rank aborted: that is the finding
            direct[op] = f"a rank aborted: {str(e).splitlines()[0]}"
    log(f"gloo on CUDA tensors directly: {direct}")
    ranks = _spawn_ranks(_gloo_staged_rank, timeout=120)
    W = TP_WORLD
    ys = [r * 10 + np.arange(W * 2, dtype=np.float32) for r in range(W)]
    for rank, r in enumerate(ranks):
        want = {"all_reduce": sum(ys).tolist(),
                "all_gather": np.concatenate(ys).tolist(),
                "all_to_all": np.concatenate(
                    [y[2 * rank:2 * rank + 2] for y in ys]).tolist(),
                "ring_shift": ys[(rank - 1) % W].tolist()}
        if r["staged"] != want:
            raise AssertionError(f"rank {rank}: staged collectives "
                                 f"{r['staged']} vs {want}")
        log(f"rank {rank}: the rule picks {r['backend']} (host staging "
            f"{r['staging']}); through the pinned host buffers every kind "
            f"is right")
    return {"nccl": nccl, "gloo_direct": direct}


PHASES = {"toolchain": phase_toolchain, "build": phase_build,
          "k1": phase_k1, "small_engine": phase_small_engine,
          "main_path": phase_main_path, "k2": phase_k2,
          "small_trainer": phase_small_trainer,
          "main_training": phase_main_training,
          "main_path_fit": phase_main_path_fit,
          "k2_fit_probe": phase_k2_fit_probe,
          "train_seeds": phase_train_seeds, "fused": phase_fused,
          "k4_profile": phase_k4_profile, "wo_probe": phase_wo_probe,
          "small_int4_engine": phase_small_int4_engine,
          "main_path_int4": phase_main_path_int4,
          "ab_paths": phase_ab_paths, "k3": phase_k3,
          "tc_configs": phase_tc_configs,
          "small_multistream": phase_small_multistream,
          "main_path_multistream": phase_main_path_multistream,
          "main_path_dispatch": phase_main_path_dispatch,
          "mla": phase_mla,
          "small_demo": phase_small_demo,
          "main_path_demo": phase_main_path_demo,
          "small_eval": phase_small_eval,
          "main_path_eval": phase_main_path_eval,
          "small_prep": phase_small_prep,
          "main_path_prep": phase_main_path_prep,
          "main_path_web": phase_main_path_web,
          "tp_serving": phase_tp_serving, "sp_training": phase_sp_training,
          "collective_probe": phase_collective_probe}


# the default run's phases, in order
DEFAULT_RUN = ("toolchain", "build", "k1", "small_engine", "main_path", "k2",
               "small_trainer", "main_training", "main_path_fit", "fused",
               "k4_profile",
               "small_int4_engine", "main_path_int4", "ab_paths", "k3",
               "small_multistream", "main_path_multistream",
               "main_path_dispatch", "mla", "small_demo", "main_path_demo",
               "small_eval", "main_path_eval", "small_prep", "main_path_prep",
               "main_path_web", "tp_serving", "sp_training")


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--phases", default="",
        help=f"comma-separated subset of {', '.join(PHASES)} to run alone, "
             f"for work on one phase: no summary lines are printed")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import videollm_online_tpu_torch  # noqa: F401  (fails outside the repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    if args.phases:
        for name in args.phases.split(","):
            t0 = time.perf_counter()
            PHASES[name]()
            log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return 0
    out = {}
    for name in DEFAULT_RUN:
        t0 = time.perf_counter()
        out[name] = PHASES[name]()
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    smi, k1, main_path, k2, training, fit, fused, int4_path, ab, k3, \
        multistream, dispatch, mla, demo, evals, prep, web, tp, sp = (
            out[n] for n in (
                "toolchain", "k1", "main_path", "k2", "main_training",
                "main_path_fit", "fused", "main_path_int4", "ab_paths", "k3",
                "main_path_multistream", "main_path_dispatch", "mla",
                "main_path_demo", "main_path_eval", "main_path_prep",
                "main_path_web", "tp_serving", "sp_training"))
    log(f"card: {smi}; total {time.perf_counter() - t_start:.1f} s")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    k2_source = "videollm_online_tpu_torch/csrc/flash_attention.cu"
    kernels = [{
        "name": "ring_decode_attention_layered",
        "route": "cuda",
        "source": "videollm_online_tpu_torch/csrc/decode_attention.cu",
        "replaces": "videollm_online_tpu/ops/decode_attention.py:249",
        "launches": (main_path["launches"] + int4_path["launches"]["K1"]
                     + multistream["ring, bf16 KV"]["launches"]["K1"]
                     + sum(r["launches"]["K1"] for r in demo.values())
                     + evals["launches"]["K1"] + prep["launches"]["K1"]
                     + web["launches"]["K1"] + tp["launches"]["K1"]
                     + dispatch["launches"]["K1"]),
        "max_abs_err": max(k1["max_abs_err"], main_path["ring_err"],
                           evals["k1_err"], tp["errs"]["K1"]),
        **{key: k1[key] for key in keys},
    }, {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "videollm_online_tpu_torch/csrc/paged_attention.cu",
        "replaces": "videollm_online_tpu/ops/paged_attention.py:175",
        "launches": (sum(r["launches"]["K3"] for r in multistream.values())
                     + web["launches"]["K3"] + tp["launches"]["K3"]
                     + dispatch["launches"]["K3"]),
        "max_abs_err": max(k3["max_abs_err"], tp["errs"]["K3"]),
        **{key: k3[key] for key in keys},
    }]
    # the latent kernel: no Pallas site (DeepSeek-V2 is the port's own);
    # its times at the cell's ingest tick, its launches phase 15c's main path
    kernels.append({
        "name": "mla_paged_attention", "route": "cuda",
        "source": "videollm_online_tpu_torch/csrc/mla_attention.cu",
        "replaces": None, "launches": mla["launches"],
        "max_abs_err": mla["max_abs_err"],
        **{key: mla[key] for key in keys}})
    # K2f counts the training, fit and eval main paths' launches; its error
    # is the worst of phase 6's cases, the T 12288 hold and the eval
    # prefill's hold (K2b and K2q: phase 6's and the T 12288 hold)
    k2["fwd"]["max_abs_err"] = max(k2["fwd"]["max_abs_err"],
                                   evals["k2f"]["max_abs_err"])
    for part in ("fwd", "dkdv", "dq"):
        k2[part]["max_abs_err"] = max(k2[part]["max_abs_err"],
                                      fit["k2"][part]["max_abs_err"])
    for name, part, label, replaces in (
            ("flash_fwd", "fwd", "K2f",
             "videollm_online_tpu/ops/flash_attention.py:144"),
            ("flash_dkdv", "dkdv", "K2b",
             "videollm_online_tpu/ops/flash_attention.py:324"),
            ("flash_dq", "dq", "K2q",
             "videollm_online_tpu/ops/flash_attention.py:359")):
        kernels.append({"name": name, "route": "cuda", "source": k2_source,
                        "replaces": replaces,
                        "launches": (training["launches"][label]
                                     + fit["launches"][label]
                                     + evals["launches"][label]
                                     + sp["launches"][label]),
                        "max_abs_err": max(k2[part]["max_abs_err"],
                                           sp["errs"][label]),
                        **{key: k2[part][key] for key in keys}})
    # K4 and K5 count the int4 main paths' launches (phases 11, 15b and
    # 17); K6 and K7, which no serving main path reaches, those of their own
    # engine runs (phase 12)
    fused_launches = {**{k: n + demo["int4"]["launches"][k]
                         + tp["launches"].get(k, 0)
                         + dispatch["launches"].get(k, 0)
                         for k, n in int4_path["launches"].items()}, **ab}
    for label, (name, _, replaces) in FUSED_KERNELS.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": "videollm_online_tpu_torch/csrc/fused_mlp.cu",
                        "replaces": replaces,
                        "launches": fused_launches[label],
                        "max_abs_err": max(fused[label]["max_abs_err"],
                                           tp["errs"].get(label, 0.0)),
                        **{key: fused[label][key] for key in keys},
                        "dequant_route_ms": fused[label]["dequant_route_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
