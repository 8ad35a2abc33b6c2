"""A configuration file's JSON as the port's ``LiveConfig``: the only place
where the benchmark's configuration keys meet the port's config types."""

from __future__ import annotations

from typing import Any, Dict

from .weights import attention_window


def port_live_config(c: Dict[str, Any], *, max_response_tokens: int,
                     gate_logit_bias: float):
    from videollm_online_tpu_torch.core.config import LiveConfig, LlamaConfig
    live = c["live"]
    lcfg = LlamaConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        rope_theta=float(c["rope_theta"]), rms_norm_eps=c["rms_norm_eps"],
        max_position_embeddings=c["max_position_embeddings"],
        sliding_window=attention_window(c),
        attention_bias=bool(c.get("qkv_bias")),
        tie_word_embeddings=bool(c.get("tie_word_embeddings")),
        dtype=c["activations"])
    return LiveConfig(
        llama=lcfg, lora=None,
        vision_hidden_size=live["vision_hidden_size"],
        frame_num_tokens=live["frame_num_tokens"],
        frame_token_interval=live["frame_token_interval"],
        frame_fps=float(live["frame_fps"]),
        max_num_frames=live["max_num_frames"],
        frame_token_interval_threshold=live["frame_token_interval_threshold"],
        max_response_tokens=max_response_tokens,
        gate_logit_bias=float(gate_logit_bias),
        system_prompt=live["system_prompt"])
