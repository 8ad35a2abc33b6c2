"""CLI streaming demo: paced frame feed, live dialogue, FPS accounting.

Counterpart of ``videollm_online_tpu/serve/cli.py`` (reference
demo/cli.py): load pre-extracted features, seed an initial query, then tick
frame by frame calling the engine and timing each tick ("Average Processing
FPS"); the conversation history is written as JSON at the end.

Usage:
  python -m videollm_online_tpu_torch.serve.cli --video feats.{npy,pt} \\
      [--model_size tiny|1b|8b] [--quantize int8|int4] [--spec_decode] \\
      [--checkpoint DIR] [--device cpu] [--num_ticks 100] [--output out.json]

The model runs on the card unless ``--device cpu`` asks for the CPU. Without
a checkpoint the weights are random, drawn from ``--seed`` (smoke and
performance runs); ``--model_size 8b`` is then built quantized in place
(int8, or the mixed int4 layout with ``--quantize int4``). ``--checkpoint``
takes an adapter directory as ``train/checkpoints.save_adapter`` writes it
(LoRA and connector) over a random base. The flags of the options the
engine does not carry yet (``--with_vision``, ``--vision_checkpoint``,
``--kv_quant``, ``--speculative``, ``--pipelined``, ``--stream_tokens``) are
parsed and raise ``NotImplementedError``.
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
from ..models.builder import PROXY_SIZES
from ..tokenizer.live_tokenizer import LiveTokenizer
from ..tokenizer.tiny import ByteTokenizer

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


def build_model(args):
    """(params, tokenizer, cfg, vision_params) for every serving surface,
    without allocating any engine state. ``vision_params`` is always None:
    the vision tower is a later slice."""
    if args.with_vision or args.vision_checkpoint:
        raise NotImplementedError(
            "--with_vision / --vision_checkpoint need the vision slice; the "
            "port serves pre-extracted features")
    device = resolve_device(getattr(args, "device", None) or None)
    quantize = getattr(args, "quantize", "")
    bits = {"": 0, "int8": 8, "int4": 4}[quantize]
    llama_cfg = LlamaConfig(**PROXY_SIZES[args.model_size], dtype=args.dtype)
    cfg = live1_plus_config(llama=llama_cfg, lora=None)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    adapter = None
    if args.checkpoint:
        adapter = torch.load(os.path.join(args.checkpoint, "adapter.pt"),
                             map_location=device, weights_only=True)
        if "lora" in adapter:
            cfg = cfg.replace(lora=_adapter_lora_config(adapter))
    tok = _tokenizer(args.tokenizer, cfg)
    cfg = tok.cfg

    if adapter is not None:
        from ..train import checkpoints
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
    return params, tok, cfg, None


def build_engine(args):
    from .engine import LiveInferEngine

    params, tok, cfg, vision_params = build_model(args)
    stream_tokens = getattr(args, "stream_tokens", 0) or None
    on_delta = None
    if stream_tokens:
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
                   help=".npy / .npz / .pt pre-extracted features")
    p.add_argument("--checkpoint", default="",
                   help="adapter directory (train/checkpoints.save_adapter)")
    p.add_argument("--vision_checkpoint", default="")
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
    p.add_argument("--with_vision", action="store_true")
    p.add_argument("--query", default="Please narrate the video in real time.")
    p.add_argument("--num_ticks", type=int, default=100)
    p.add_argument("--warmup_ticks", type=int, default=2,
                   help="ticks excluded from the FPS average (the first "
                        "calls build the kernels)")
    p.add_argument("--kv_capacity", type=int, default=16384)
    p.add_argument("--kv_quant", default="", choices=["", "int8"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default="cli_history.json")
    p.add_argument("--speculative", action="store_true")
    p.add_argument("--spec_decode", action="store_true",
                   help="n-gram speculative decoding inside response "
                        "generation; transcripts equal to greedy")
    p.add_argument("--spec_draft", type=int, default=0,
                   help="drafted tokens per verify step (0 = default)")
    p.add_argument("--pipelined", action="store_true")
    p.add_argument("--stream_tokens", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    engine, cfg = build_engine(args)
    engine.load_video(args.video)
    engine.input_query_stream(args.query, video_time=0.0)
    on_card = engine.device.type == "cuda"

    fps = engine.frame_fps
    history = {"video": args.video, "messages": []}
    times = []
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
            times.append(dt)
        for role, msg in (("user", query), ("assistant", response)):
            if msg:
                history["messages"].append(
                    {"role": role, "content": msg, "fps": 1.0 / dt})
                print(msg)
    avg_fps = len(times) / sum(times) if times else 0.0
    history["average_processing_fps"] = avg_fps
    print(f"Average Processing FPS: {avg_fps:.2f}")
    with open(args.output, "w") as f:
        json.dump(history, f, indent=1)


if __name__ == "__main__":
    main()
