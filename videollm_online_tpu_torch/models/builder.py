"""Model + tokenizer factory.

Counterpart of ``videollm_online_tpu/models/builder.py`` (reference
``build_model_and_tokenizer``, models/modeling_live.py:184-222): resolves
the tokenizer (adding ``<v>``), builds the random base (a proxy size or the
configured one), attaches LoRA + connector, optionally restores an adapter
checkpoint (the port's format, train/checkpoints.py) and, with
``--quantize_base int8``, stores the frozen base as weight-only int8.
Loading converted HF weights (``llm_weights``) needs ``models/convert.py``
and is refused until ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch

from ..core.arguments import LiveTrainingArguments
from ..core.config import LiveConfig, LlamaConfig
from ..core.device import resolve_device
from ..tokenizer.live_tokenizer import LiveTokenizer, build_live_tokenizer
from ..tokenizer.tiny import ByteTokenizer
from ..train import checkpoints
from . import live, quant

PROXY_SIZES = {
    "tiny": dict(vocab_size=2048, hidden_size=256, intermediate_size=512,
                 num_layers=4, num_heads=8, num_kv_heads=4, head_dim=32),
    "1b": dict(vocab_size=128256, hidden_size=2048, intermediate_size=8192,
               num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64),
    "8b": dict(),  # the LlamaConfig defaults are Llama-3-8B
}


def build_model_and_tokenizer(args: LiveTrainingArguments, *, seed: int = 0,
                              device=None
                              ) -> Tuple[Dict[str, Any], LiveTokenizer,
                                         LiveConfig]:
    """(params, tokenizer, cfg) with random weights drawn from ``seed`` on
    ``device`` (the card unless the caller asks for the CPU)."""
    if args.llm_weights:
        raise NotImplementedError(
            "llm_weights needs models/convert.py, which comes with ROADMAP "
            "Queue 1 item 12 (weights and build)")
    if args.mlp_chunk:
        raise NotImplementedError(
            "mlp_chunk fits 8B into one 16 GiB chip; the port drops it "
            "(ROADMAP, dropped 16 GiB-fit mechanisms)")
    if args.quantize_base not in ("", "int8"):
        raise ValueError(f"quantize_base must be '' or 'int8', got "
                         f"{args.quantize_base!r}")
    device = resolve_device(device)
    cfg = args.to_live_config()
    if args.model_size:
        cfg = cfg.replace(llama=LlamaConfig(
            **PROXY_SIZES[args.model_size],
            dtype="bfloat16" if args.bf16 else "float32"))

    if args.tokenizer_path:
        from transformers import AutoTokenizer
        tok = build_live_tokenizer(
            AutoTokenizer.from_pretrained(args.tokenizer_path, use_fast=True,
                                          padding_side="left"), cfg)
    else:
        tok = LiveTokenizer(ByteTokenizer(), cfg)
    cfg = tok.cfg

    gen = torch.Generator(device=device).manual_seed(seed)
    params = live.init_params(gen, cfg, device=device)
    if args.resume_from_checkpoint:
        path = args.resume_from_checkpoint
        if os.path.isdir(os.path.join(path, "adapter")):
            path = os.path.join(path, "adapter")
        params = checkpoints.load_adapter_into(params, path)
    if args.quantize_base:
        # QLoRA-analog: the frozen base decoder is weight-only int8; LoRA +
        # connector stay trainable and gradients flow through the
        # dequantizing matmuls (models/quant.py)
        if cfg.lora is None:
            raise ValueError("--quantize_base needs LoRA: an int8 base "
                             "cannot take gradient updates itself")
        params["llama"] = quant.quantize_llama_params(params["llama"])
    return params, tok, cfg
