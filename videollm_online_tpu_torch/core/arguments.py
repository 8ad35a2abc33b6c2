"""CLI argument system with live1/live1+ preset dispatch.

A copy of ``videollm_online_tpu/core/arguments.py``: the port imports
nothing from the JAX package, so it keeps its own copy. ``--live_version``
is parsed first and selects the preset defaults, then the full parse runs
with those defaults (reference models/arguments_live.py:5-54,
models/__init__.py:7-10). The fields are the JAX package's, so one command
line means the same run on both; the port refuses the ones whose mechanism
it does not carry (``LiveTrainer`` and ``build_model_and_tokenizer`` say
which).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field, fields
from typing import List, Optional

from .config import LiveConfig, LoraConfig, live1_config, live1_plus_config


@dataclass
class LiveTrainingArguments:
    live_version: str = "live1+"
    system_prompt: str = (
        "A multimodal AI assistant is helping users with some activities."
        " Below is their conversation, interleaved with the list of video"
        " frames received by the assistant.")
    train_datasets: List[str] = field(default_factory=list)
    eval_datasets: List[str] = field(default_factory=list)
    stream_loss_weight: float = 1.0
    llm_pretrained: str = "meta-llama/Meta-Llama-3-8B-Instruct"
    llm_weights: str = ""          # converted safetensors dir
    tokenizer_path: str = ""       # HF tokenizer dir (empty -> byte tokenizer)
    vision_pretrained: str = "google/siglip-large-patch16-384"
    vision_hidden_size: int = 1024
    lora_r: int = 128
    lora_alpha: int = 256
    finetune_modules: List[str] = field(default_factory=lambda: ["connector"])
    frame_fps: float = 2.0
    frame_token_cls: bool = True
    frame_token_pooled: Optional[List[int]] = None
    frame_resolution: int = 384
    frame_num_tokens: int = 10
    frame_token_interval: str = ","
    frame_token_interval_threshold: float = 0.0
    embed_mark: str = "2fps_384_1+3x3"
    max_num_frames: int = 1200
    augmentation: bool = False
    # 'auto' | 'xla' | 'pallas_flash' | 'sp_ring' | 'sp_ulysses' (the JAX
    # package's names; in the port 'auto' and 'pallas_flash' dispatch by
    # shape to the CUDA kernels, 'xla' is the plain attention, sp_* are
    # the ring and Ulysses attentions over the model axis)
    attn_implementation: str = "auto"
    output_dir: str = "outputs/debug"

    # training hyperparameters (reference scripts/*.sh)
    learning_rate: float = 2e-4
    warmup_ratio: float = 0.05
    num_train_epochs: float = 2.0
    per_device_train_batch_size: int = 1
    gradient_accumulation_steps: int = 8
    max_steps: int = 0             # overrides epochs when > 0
    logging_steps: int = 10
    save_strategy: str = "no"      # 'no' | 'epoch' | 'steps'
    save_steps: int = 0
    seed: int = 42
    bf16: bool = True
    gradient_checkpointing: bool = True
    dataloader_num_workers: int = 16
    pad_to_multiple: int = 256
    resume_from_checkpoint: str = ""
    # parallelism: the model axis of the (data, model) mesh over the
    # processes, and the partition rules (parallel/sharding.py)
    mesh_model_axis: int = 1
    sharding_policy: str = "fsdp_tp"
    # the ZeRO-2 CPU-offload analog: the Adam moments live in pinned host
    # memory between steps (train/offload.py)
    offload_optimizer: bool = False
    # QLoRA-analog: the frozen base decoder as weight-only int8 ("int8");
    # LoRA + connector stay trainable and gradients flow through the
    # dequantizing matmuls
    quantize_base: str = ""       # '' | 'int8'
    # stream the weighted CE through LOSS_CHUNK-position lm_head chunks
    # (models/live.py _stream_ce_loss_chunked); the loss value is the same
    chunked_loss: bool = False
    loss_chunk: int = 0           # 0 = models/live.py LOSS_CHUNK
    # nested grouped remat: an outer checkpoint over every remat_group
    # layers (models/llama.py forward): the saved layer inputs shrink
    # remat_group-fold for one more forward of each layer in the backward
    remat_group: int = 1
    # each layer's MLP in mlp_chunk-position sequence slices
    # (LlamaConfig.mlp_chunk; the same values)
    mlp_chunk: int = 0
    # proxy model for smoke runs ('': use llm_pretrained weights)
    model_size: str = ""

    def to_live_config(self) -> LiveConfig:
        base = (live1_config() if self.live_version == "live1"
                else live1_plus_config())
        return base.replace(
            frame_token_cls=self.frame_token_cls,
            frame_token_pooled=(tuple(self.frame_token_pooled)
                                if self.frame_token_pooled else
                                base.frame_token_pooled),
            frame_num_tokens=self.frame_num_tokens,
            frame_resolution=self.frame_resolution,
            frame_fps=self.frame_fps,
            max_num_frames=self.max_num_frames,
            frame_token_interval=self.frame_token_interval,
            frame_token_interval_threshold=self.frame_token_interval_threshold,
            stream_loss_weight=self.stream_loss_weight,
            system_prompt=self.system_prompt,
            vision_hidden_size=self.vision_hidden_size,
            lora=LoraConfig(r=self.lora_r, alpha=self.lora_alpha),
        )


@dataclass
class LiveOneTrainingArguments(LiveTrainingArguments):
    """live1 preset: CLS only, 1 token/frame, no interval, 1h @ 2fps
    (models/arguments_live.py:31-37)."""
    live_version: str = "live1"
    frame_token_cls: bool = True
    frame_token_pooled: Optional[List[int]] = None
    frame_num_tokens: int = 1
    frame_token_interval: str = ""
    embed_mark: str = "2fps_384_1"
    max_num_frames: int = 7200


@dataclass
class LiveOnePlusTrainingArguments(LiveTrainingArguments):
    """live1+ preset: CLS + 3x3, ',' interval, 10min @ 2fps
    (models/arguments_live.py:40-47)."""
    live_version: str = "live1+"
    frame_token_cls: bool = True
    frame_token_pooled: Optional[List[int]] = field(
        default_factory=lambda: [3, 3])
    frame_num_tokens: int = 10
    frame_token_interval: str = ","
    embed_mark: str = "2fps_384_1+3x3"
    max_num_frames: int = 1200


def get_args_class(live_version: str):
    if live_version == "live1":
        return LiveOneTrainingArguments
    if live_version == "live1+":
        return LiveOnePlusTrainingArguments
    raise NotImplementedError(live_version)


def _add_fields(parser: argparse.ArgumentParser, cls) -> None:
    for f in fields(cls):
        name = f"--{f.name}"
        default = (f.default if f.default is not dataclasses.MISSING
                   else f.default_factory())
        if f.type in ("bool", bool) or isinstance(default, bool):
            parser.add_argument(name, type=lambda s: s.lower() in
                                ("1", "true", "yes"), default=default)
        elif isinstance(default, list) or "List" in str(f.type):
            parser.add_argument(name, nargs="*", default=default,
                                type=int if "int" in str(f.type) else str)
        elif isinstance(default, float):
            parser.add_argument(name, type=float, default=default)
        elif isinstance(default, int):
            parser.add_argument(name, type=int, default=default)
        else:
            parser.add_argument(name, type=str, default=default)


def parse_args(argv: Optional[List[str]] = None) -> LiveTrainingArguments:
    """Two-pass parse: live_version first, then the preset class
    (models/__init__.py:7-10)."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--live_version", default="live1+")
    known, _ = pre.parse_known_args(argv)
    cls = get_args_class(known.live_version)
    parser = argparse.ArgumentParser()
    _add_fields(parser, cls)
    ns = parser.parse_args(argv)
    kwargs = {f.name: getattr(ns, f.name) for f in fields(cls)}
    return cls(**kwargs)
