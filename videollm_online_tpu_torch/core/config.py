"""Typed configuration tree for the PyTorch port of VideoLLM-online.

A copy of ``videollm_online_tpu/core/config.py``: the port imports nothing
from the JAX package, so it keeps its own copy of the framework-free config.

One immutable dataclass tree replaces the reference's mutable
``PretrainedConfig`` mixin (reference: models/configuration_live.py:5-21) and
its HfArgumentParser dataclasses (reference: models/arguments_live.py:5-47).
Derived tokenizer ids (``v_placeholder_id`` etc., which the reference mutates
into the config at tokenizer-build time, tokenization_live.py:119) are filled
in explicitly via :meth:`LiveConfig.with_tokenizer_ids` — no hidden mutation.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class LlamaConfig:
    """Decoder (Llama-3 family) architecture hyperparameters."""

    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    # Mistral-style sliding-window attention (None = full causal). The
    # reference notes swapping the Llama parent for Mistral as the
    # multi-family extension point (reference README.md:108).
    sliding_window: Optional[int] = None
    # Qwen2-style bias on the q/k/v projections (o_proj and MLP stay
    # bias-free in that family).
    attention_bias: bool = False
    # numerics policy: parameters/activations bf16, softmax/norm/loss fp32
    dtype: str = "bfloat16"
    # Long-sequence training memory: each layer's SwiGLU MLP runs in
    # (B, mlp_chunk, D) sequence slices, each checkpointed, so the
    # backward holds one slice's (mlp_chunk, intermediate) temps instead of
    # the whole sequence's (models/llama.py ``_mlp_seq_chunked``; the same
    # values). 0 = off; applies only when S is a multiple of mlp_chunk and
    # larger, so decode shapes are unaffected.
    mlp_chunk: int = 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class VisionConfig:
    """SigLIP-style ViT encoder hyperparameters.

    Defaults match google/siglip-large-patch16-384 (reference:
    models/vision_live.py:54-61, models/arguments_live.py:15).
    """

    image_size: int = 384
    patch_size: int = 16
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    layer_norm_eps: float = 1e-6
    # preprocessing (reference: models/vision_live.py:10-13)
    mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    std: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    rescale_factor: float = 1.0 / 255.0
    family: str = "siglip"  # or "clip"
    dtype: str = "bfloat16"

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size


@dataclass(frozen=True)
class LoraConfig:
    """LoRA adapter spec (reference: models/modeling_live.py:203-213)."""

    r: int = 128
    alpha: int = 256
    dropout: float = 0.05
    # which projections inside the decoder carry adapters
    target_modules: Tuple[str, ...] = (
        "q_proj", "k_proj", "v_proj", "o_proj",
        "gate_proj", "up_proj", "down_proj", "lm_head",
    )

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


@dataclass(frozen=True)
class LiveConfig:
    """Everything the streaming-video dialogue layer needs.

    Mirrors the semantic content of the reference's LiveConfigMixin
    (models/configuration_live.py:5-21) + the live1/live1+ argument presets
    (models/arguments_live.py:31-47).
    """

    llama: LlamaConfig = field(default_factory=LlamaConfig)
    vision: VisionConfig = field(default_factory=VisionConfig)
    lora: Optional[LoraConfig] = field(default_factory=LoraConfig)

    live_version: str = "live1+"
    # frame token layout
    frame_token_cls: bool = True
    frame_token_pooled: Optional[Tuple[int, int]] = (3, 3)
    frame_num_tokens: int = 10  # 1 CLS + 3x3 pooled
    frame_resolution: int = 384
    frame_fps: float = 2.0
    max_num_frames: int = 1200

    # token plumbing
    v_placeholder: str = "<v>"
    frame_token_interval: str = ","  # '' for live1
    v_placeholder_id: Optional[int] = None
    frame_token_interval_id: Optional[int] = None
    eos_token_id: Optional[int] = None
    bos_token_id: Optional[int] = None

    # loss
    stream_loss_weight: float = 1.0
    vision_hidden_size: int = 1024

    # serving
    frame_token_interval_threshold: float = 0.725  # reference demo/inference.py:31
    max_response_tokens: int = 100  # reference demo/inference.py:30
    # additive logit bias on the gate (interval) token before the softmax in
    # the serving gate — a runtime response-rate control complementary to the
    # threshold (0.0 = exact reference behavior). Positive values make the
    # model hold (emit ','), negative make it respond more eagerly; also the
    # lever benchmarks use to pin a response schedule under random weights.
    gate_logit_bias: float = 0.0

    system_prompt: str = (
        "A multimodal AI assistant is helping users with some activities."
        " Below is their conversation, interleaved with the list of video"
        " frames received by the assistant."
    )

    def with_tokenizer_ids(
        self,
        *,
        v_placeholder_id: int,
        frame_token_interval_id: Optional[int],
        eos_token_id: int,
        bos_token_id: Optional[int] = None,
    ) -> "LiveConfig":
        return dataclasses.replace(
            self,
            v_placeholder_id=v_placeholder_id,
            frame_token_interval_id=frame_token_interval_id,
            eos_token_id=eos_token_id,
            bos_token_id=bos_token_id,
        )

    def replace(self, **kw) -> "LiveConfig":
        return dataclasses.replace(self, **kw)


def live1_config(**overrides) -> LiveConfig:
    """live1 preset: 1 CLS token/frame, no interval token, 1h @ 2fps.

    Reference: models/arguments_live.py:31-37.
    """
    cfg = LiveConfig(
        live_version="live1",
        frame_token_cls=True,
        frame_token_pooled=None,
        frame_num_tokens=1,
        frame_token_interval="",
        max_num_frames=7200,
    )
    return cfg.replace(**overrides) if overrides else cfg


def live1_plus_config(**overrides) -> LiveConfig:
    """live1+ preset: CLS + 3x3 pooled tokens, ',' interval, 10min @ 2fps.

    Reference: models/arguments_live.py:40-47.
    """
    cfg = LiveConfig()
    return cfg.replace(**overrides) if overrides else cfg


def mistral_7b_config(**overrides) -> LlamaConfig:
    """Mistral-7B-Instruct architecture (the reference's documented second
    LLM family): same block as Llama with 4k sliding-window attention."""
    kw = dict(
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=10000.0,
        max_position_embeddings=32768,
        sliding_window=4096,
    )
    kw.update(overrides)
    return LlamaConfig(**kw)


def qwen2_7b_config(**overrides) -> LlamaConfig:
    """Qwen2-7B-Instruct architecture (third LLM family): Llama block with
    bias on the q/k/v projections and 1e6 rope base."""
    kw = dict(
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_layers=28,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        rope_theta=1e6,
        rms_norm_eps=1e-6,
        max_position_embeddings=32768,
        attention_bias=True,
    )
    kw.update(overrides)
    return LlamaConfig(**kw)


# ---------------------------------------------------------------------------
# tiny proxy configs for tests / CPU development


def tiny_llama_config(**overrides) -> LlamaConfig:
    kw = dict(
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        max_position_embeddings=4096,
        dtype="float32",
    )
    kw.update(overrides)
    return LlamaConfig(**kw)


def tiny_vision_config(**overrides) -> VisionConfig:
    kw = dict(
        image_size=32,
        patch_size=16,
        hidden_size=32,
        intermediate_size=64,
        num_layers=2,
        num_heads=2,
        dtype="float32",
    )
    kw.update(overrides)
    return VisionConfig(**kw)


def tiny_live_config(**overrides) -> LiveConfig:
    base = dict(
        llama=tiny_llama_config(),
        vision=tiny_vision_config(),
        lora=LoraConfig(r=4, alpha=8),
        vision_hidden_size=32,
        max_num_frames=64,
    )
    base.update(overrides)
    return LiveConfig(**base)
