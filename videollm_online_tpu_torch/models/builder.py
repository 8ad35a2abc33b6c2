"""Model + tokenizer factory.

Counterpart of ``videollm_online_tpu/models/builder.py`` (reference
``build_model_and_tokenizer``, models/modeling_live.py:184-222): resolves
the tokenizer (adding ``<v>``), loads the base from HF safetensors
(``llm_weights``, through models/convert.py) or builds it at random (a
proxy size or the configured one), attaches LoRA + connector, optionally
restores an adapter checkpoint (the port's format, train/checkpoints.py)
and, with ``--quantize_base int8``, stores the frozen base as weight-only
int8. ``build_vision_params`` gives the SigLIP tower's weights: converted
from an HF checkpoint, restored from a saved tree, or random.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Tuple

import torch

from ..core.arguments import LiveTrainingArguments
from ..core.config import LiveConfig, LlamaConfig
from ..core.device import resolve_device
from ..tokenizer.live_tokenizer import LiveTokenizer, build_live_tokenizer
from ..tokenizer.tiny import ByteTokenizer
from ..train import checkpoints
from . import convert, live, llama, quant, siglip

PROXY_SIZES = {
    "tiny": dict(vocab_size=2048, hidden_size=256, intermediate_size=512,
                 num_layers=4, num_heads=8, num_kv_heads=4, head_dim=32),
    "1b": dict(vocab_size=128256, hidden_size=2048, intermediate_size=8192,
               num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64),
    "8b": dict(),  # the LlamaConfig defaults are Llama-3-8B
}


def build_model_and_tokenizer(args: LiveTrainingArguments, *,
                              is_training: bool = True, seed: int = 0,
                              device=None
                              ) -> Tuple[Dict[str, Any], LiveTokenizer,
                                         LiveConfig]:
    """(params, tokenizer, cfg) with random weights drawn from ``seed`` on
    ``device`` (the card unless the caller asks for the CPU).
    ``is_training`` has no effect, as in the JAX builder: evaluation builds
    the same tree (LoRA stays attached, the adapter is restored over it).
    It is kept so the entry points call the builder as the JAX ones do.
    ``args.mlp_chunk`` becomes the decoder's ``LlamaConfig.mlp_chunk``."""
    if args.quantize_base not in ("", "int8"):
        raise ValueError(f"quantize_base must be '' or 'int8', got "
                         f"{args.quantize_base!r}")
    device = resolve_device(device)
    cfg = args.to_live_config()
    if args.model_size:
        cfg = cfg.replace(llama=LlamaConfig(
            **PROXY_SIZES[args.model_size],
            dtype="bfloat16" if args.bf16 else "float32"))
    if args.mlp_chunk:
        cfg = cfg.replace(llama=dataclasses.replace(
            cfg.llama, mlp_chunk=args.mlp_chunk))

    if args.tokenizer_path:
        from transformers import AutoTokenizer
        tok = build_live_tokenizer(
            AutoTokenizer.from_pretrained(args.tokenizer_path, use_fast=True,
                                          padding_side="left"), cfg)
    else:
        tok = LiveTokenizer(ByteTokenizer(), cfg)
    cfg = tok.cfg

    gen = torch.Generator(device=device).manual_seed(seed)
    if args.llm_weights:
        sd = convert.load_safetensors_state_dict(args.llm_weights)
        params = {"llama": convert.llama_params_from_state_dict(
                      sd, cfg.llama, device=device),
                  "connector": live.init_connector(gen, cfg, device=device)}
        if cfg.lora is not None:
            params["lora"] = llama.init_lora_params(gen, cfg.llama, cfg.lora,
                                                    device)
    else:
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


def build_vision_params(cfg: LiveConfig, *, checkpoint: str = "",
                        seed: int = 1, device=None) -> Dict[str, Any]:
    """The SigLIP tower's weights on ``device``, in ``cfg.vision.dtype``: an
    HF checkpoint (a ``.safetensors`` file or a directory of them), a tree
    saved with ``torch.save`` (``.pt``), or, without a checkpoint, random
    weights drawn from ``seed``. The engines encode frames with SigLIP
    (``live.pixels_to_embeds``), so this builds no other family."""
    device = resolve_device(device)
    if checkpoint.endswith(".pt"):
        tree = torch.load(checkpoint, map_location=device, weights_only=True)
        return _cast_floats(tree, cfg.vision.dtype)
    if checkpoint:
        sd = convert.load_safetensors_state_dict(checkpoint)
        return convert.siglip_params_from_state_dict(sd, cfg.vision,
                                                     device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return siglip.init_params(gen, cfg.vision, device=device)


def _cast_floats(tree, dtype: str):
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    return tree.to(getattr(torch, dtype)) if tree.is_floating_point() else tree
