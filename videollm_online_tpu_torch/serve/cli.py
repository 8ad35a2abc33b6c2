"""CLI streaming demo: paced frame feed, live dialogue, FPS accounting.

Counterpart of ``videollm_online_tpu/serve/cli.py`` (reference
demo/cli.py): load a video (or its pre-extracted features), seed an initial
query, then tick frame by frame calling the engine and timing each tick,
frame encoding included ("Average Processing FPS"); the conversation
history is written as JSON at the end.

Usage:
  python -m videollm_online_tpu_torch.serve.cli \\
      --video clip.{avi,mp4} --with_vision | --video feats.{npy,pt} \\
      [--model_size tiny|1b|8b] [--quantize int8|int4] [--spec_decode] \\
      [--kv_quant int8] [--stream_tokens S] [--vision_checkpoint PATH] \\
      [--checkpoint DIR] [--device cpu] [--num_ticks 100] [--output out.json]

The model runs on the card unless ``--device cpu`` asks for the CPU. Without
a checkpoint the weights are random, drawn from ``--seed`` (smoke and
performance runs); ``--model_size 8b`` is then built quantized in place
(int8, or the mixed int4 layout with ``--quantize int4``). ``--checkpoint``
takes, told apart by what the directory holds, a params tree as
``train/checkpoints.save_params`` writes it: a whole model ``{llama,
connector[, lora]}`` served as it is, or a bare decoder (the weight
converter's output, ``tools/convert_weights.py``) that gets a random
connector from ``--seed``; or an adapter directory as
``train/checkpoints.save_adapter`` writes it (LoRA and connector) over a
random base. A tree is served in ``--dtype`` and quantized under
``--quantize``. A video file (``.avi`` read by the
first-party reader, other containers through an ``ffmpeg`` binary when one
is found) needs the SigLIP tower: ``--with_vision`` builds it at random,
``--vision_checkpoint`` loads it (HF safetensors, or a ``.pt`` tree).
``--kv_quant int8`` serves over the int8 KV ring; ``--stream_tokens S``
prints each response in segments of S tokens. ``--speculative`` and
``--pipelined`` (dispatch modes of the JAX engine) raise
``NotImplementedError``: ROADMAP Queue 1 item 2.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..core.config import LlamaConfig, LoraConfig, live1_plus_config
from ..core.device import resolve_device
from ..models import live, quant
from ..models.builder import PROXY_SIZES, build_vision_params
from ..tokenizer.live_tokenizer import LiveTokenizer
from ..tokenizer.tiny import ByteTokenizer
from ..train import checkpoints

_LORA_TARGETS = {"wq": "q_proj", "wk": "k_proj", "wv": "v_proj",
                 "wo": "o_proj", "w_gate": "gate_proj", "w_up": "up_proj",
                 "w_down": "down_proj"}


def _tokenizer(path: str, cfg):
    if not path:
        return LiveTokenizer(ByteTokenizer(), cfg)
    from ..tokenizer.live_tokenizer import build_live_tokenizer
    tk_json = os.path.join(path, "tokenizer.json")
    if os.path.isdir(path) and os.path.exists(tk_json) and not os.path.exists(
            os.path.join(path, "tokenizer_config.json")):
        # a bare tokenizer.json asset
        from transformers import PreTrainedTokenizerFast
        hf = PreTrainedTokenizerFast(
            tokenizer_file=tk_json, bos_token="<|begin_of_text|>",
            eos_token="<|eot_id|>")
    else:
        from transformers import AutoTokenizer
        hf = AutoTokenizer.from_pretrained(path)
    return build_live_tokenizer(hf, cfg)


def _adapter_lora_config(adapter) -> LoraConfig:
    """The LoRA config an adapter was trained with, from its tree: the rank
    from ``lora_a``, the targets from the keys, alpha = 2 r (the ratio of
    every preset of core/config.py)."""
    layers = adapter["lora"].get("layers", {})
    pairs = list(layers.values()) + ([adapter["lora"]["lm_head"]]
                                     if "lm_head" in adapter["lora"] else [])
    r = int(pairs[0]["lora_a"].shape[-2])
    targets = tuple(_LORA_TARGETS[n] for n in layers) + (
        ("lm_head",) if "lm_head" in adapter["lora"] else ())
    return LoraConfig(r=r, alpha=2 * r, target_modules=targets)


def _serving_dtype(tree, dtype: str):
    """A restored tree's floating leaves in ``dtype``, but for the
    quantization scales (``"scale"`` keys), which stay fp32; int8 codes and
    packed int4 bytes stay as they are."""
    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key == "scale" or not node.is_floating_point():
            return node
        return node.to(getattr(torch, dtype))
    return walk(tree)


def build_model(args):
    """(params, tokenizer, cfg, vision_params) for every serving surface,
    without allocating any engine state; ``vision_params`` is None unless
    ``--with_vision`` or ``--vision_checkpoint`` asks for the tower."""
    device = resolve_device(getattr(args, "device", None) or None)
    quantize = getattr(args, "quantize", "")
    bits = {"": 0, "int8": 8, "int4": 4}[quantize]
    llama_cfg = LlamaConfig(**PROXY_SIZES[args.model_size], dtype=args.dtype)
    cfg = live1_plus_config(llama=llama_cfg, lora=None)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    adapter = tree = None
    if args.checkpoint:
        if os.path.exists(os.path.join(args.checkpoint,
                                       checkpoints.ADAPTER_FILE)):
            adapter = torch.load(
                os.path.join(args.checkpoint, checkpoints.ADAPTER_FILE),
                map_location=device, weights_only=True)
        else:
            tree = checkpoints.restore_params(args.checkpoint, device=device)
        saved = adapter if adapter is not None else tree
        if "lora" in saved:
            cfg = cfg.replace(lora=_adapter_lora_config(saved))
    tok = _tokenizer(args.tokenizer, cfg)
    cfg = tok.cfg

    if tree is not None:
        if "llama" not in tree:
            # a bare decoder: the connector rides in the adapter checkpoint
            # (reference modules_to_save=['connector'])
            tree = {"llama": tree,
                    "connector": live.init_connector(gen, cfg, device=device)}
        params = _serving_dtype(tree, args.dtype)
        if bits:
            params = quant.quantize_live_params(params, bits=bits)
    elif adapter is not None:
        params = checkpoints.load_adapter_into(
            live.init_params(gen, cfg, device=device), args.checkpoint)
        if bits:
            params = quant.quantize_live_params(params, bits=bits)
    elif bits or args.model_size == "8b":
        # 8B in bf16 is 16 GB of weights: serve it int8 or int4, built
        # quantized in place
        params = {
            "llama": quant.random_quantized_llama_params(
                gen, cfg.llama, bits=bits or 8, device=device),
            "connector": live.init_connector(gen, cfg, device=device),
        }
    else:
        params = live.init_params(gen, cfg, device=device)
    vision_params = None
    if args.vision_checkpoint or args.with_vision:
        vision_params = build_vision_params(
            cfg, checkpoint=args.vision_checkpoint, seed=1, device=device)
    return params, tok, cfg, vision_params


def build_engine(args):
    from .engine import LiveInferEngine

    params, tok, cfg, vision_params = build_model(args)
    stream_tokens = getattr(args, "stream_tokens", 0) or None
    on_delta = None
    if stream_tokens:
        # the budget rounded down to a multiple of the segment length
        if cfg.max_response_tokens % stream_tokens:
            cfg = cfg.replace(max_response_tokens=(
                cfg.max_response_tokens // stream_tokens) * stream_tokens)

        def on_delta(delta, done):
            print(delta, end="\n" if done else "", flush=True)
    return LiveInferEngine(
        params, tok, cfg, vision_params=vision_params,
        kv_capacity=args.kv_capacity,
        speculative=getattr(args, "speculative", False),
        pipelined=getattr(args, "pipelined", False),
        kv_quant=getattr(args, "kv_quant", "") or None,
        spec_decode=getattr(args, "spec_decode", False),
        spec_draft=getattr(args, "spec_draft", None) or None,
        stream_tokens=stream_tokens, on_delta=on_delta,
        device=getattr(args, "device", None) or None), cfg


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video", required=True,
                   help=".avi (first-party reader) or another container "
                        "(needs ffmpeg) with --with_vision, or .npy / .npz "
                        "/ .pt pre-extracted features")
    p.add_argument("--checkpoint", default="",
                   help="a params tree (train/checkpoints.save_params: a "
                        "whole model or a bare decoder) or an adapter "
                        "directory (train/checkpoints.save_adapter)")
    p.add_argument("--vision_checkpoint", default="",
                   help="SigLIP weights: HF safetensors (a file or a "
                        "directory) or a .pt tree")
    p.add_argument("--tokenizer", default="",
                   help="HF tokenizer path (omit for the byte test tokenizer)")
    p.add_argument("--model_size", default="tiny",
                   choices=["tiny", "1b", "8b"])
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--quantize", default="", choices=["", "int8", "int4"],
                   help="weight-only int8/int4 (int8 implied for "
                        "--model_size 8b without a checkpoint)")
    p.add_argument("--device", default="",
                   help="torch device; the card unless given (cpu runs the "
                        "plain PyTorch path)")
    p.add_argument("--with_vision", action="store_true",
                   help="random SigLIP-large tower (seed 1) to encode raw "
                        "frames")
    p.add_argument("--query", default="Please narrate the video in real time.")
    p.add_argument("--num_ticks", type=int, default=100)
    p.add_argument("--warmup_ticks", type=int, default=2,
                   help="ticks excluded from the FPS average (the first "
                        "calls build the kernels)")
    p.add_argument("--kv_capacity", type=int, default=16384)
    p.add_argument("--kv_quant", default="", choices=["", "int8"],
                   help="int8 KV ring: half the KV memory and reads; slight "
                        "quantization noise on transcripts")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default="cli_history.json")
    p.add_argument("--speculative", action="store_true")
    p.add_argument("--spec_decode", action="store_true",
                   help="n-gram speculative decoding inside response "
                        "generation; transcripts equal to greedy")
    p.add_argument("--spec_draft", type=int, default=0,
                   help="drafted tokens per verify step (0 = default)")
    p.add_argument("--pipelined", action="store_true")
    p.add_argument("--stream_tokens", type=int, default=0,
                   help="S > 0: print each response in segments of S "
                        "decoded tokens (composes with --spec_decode)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    engine, _ = build_engine(args)
    return run(engine, args)[0]


def run(engine, args):
    """The demo loop of ``main`` on a built engine: load the video, ask the
    query, tick frame by frame, print the dialogue and "Average Processing
    FPS", write the history JSON. Returns (history, ticks) with ticks the
    (seconds, responded) of every timed tick."""
    engine.load_video(args.video)
    engine.input_query_stream(args.query, video_time=0.0)
    on_card = engine.device.type == "cuda"

    fps = engine.frame_fps
    history = {"video": args.video, "messages": []}
    ticks = []
    max_time = engine.num_video_frames / fps
    for i in range(args.num_ticks):
        t = i / fps
        if t > max_time:
            break
        start = time.perf_counter()
        engine.input_video_stream(t)
        query, response = engine()
        if on_card:
            torch.cuda.synchronize(engine.device)
        dt = time.perf_counter() - start
        if i >= args.warmup_ticks:
            ticks.append((dt, response is not None))
        for role, msg in (("user", query), ("assistant", response)):
            if msg:
                history["messages"].append(
                    {"role": role, "content": msg, "fps": 1.0 / dt})
                print(msg)
    for query, response in engine.flush():  # nothing on the blocking path
        for role, msg in (("user", query), ("assistant", response)):
            if msg:
                history["messages"].append({"role": role, "content": msg})
                print(msg)
    total = sum(dt for dt, _ in ticks)
    avg_fps = len(ticks) / total if ticks else 0.0
    history["average_processing_fps"] = avg_fps
    print(f"Average Processing FPS: {avg_fps:.2f}")
    with open(args.output, "w") as f:
        json.dump(history, f, indent=1)
    return history, ticks


if __name__ == "__main__":
    main()
