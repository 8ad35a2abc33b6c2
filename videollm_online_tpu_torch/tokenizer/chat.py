"""Streaming chat template + character-level learn-range computation.

Pure string/index logic, a faithful re-implementation of the reference's
Jinja2 template and offset bookkeeping (models/tokenization_live.py:27-108).
Rendered layout::

    <bos>system prompt\n
    \n[<v><v>...,<v>...]          <- stream message, frame tokens joined by ','
    \nUser: ...
    \nAssistant: ...<eos>

Learnable supervision is expressed as *character ranges* into the rendered
string; the collator maps them to token label positions via the tokenizer's
offset mapping (reference data/data_collator.py:14-23). For a learnable
stream message the supervised char span after each frame is the interval
token (live1+) or the ``<v>`` placeholder itself (live1; the collator then
remaps those labels to EOS — the "streaming EOS" objective). The span after
the final frame is extended by one char to cover ``]\n``
(tokenization_live.py:97-99).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from ..core.config import LiveConfig

Message = Dict  # {'role': ..., 'content': ...} or {'role': 'stream', 'num_frames': N, 'learn': ...}


@dataclass(frozen=True)
class ChatFormat:
    """Template constants bound to a tokenizer's special-token strings."""
    bos_token: str
    eos_token: str


def stream_placeholder(num_frames: int, cfg: LiveConfig) -> str:
    per_frame = cfg.v_placeholder * cfg.frame_num_tokens
    return cfg.frame_token_interval.join([per_frame] * num_frames)


def stream_placeholder_len(num_frames: int, cfg: LiveConfig) -> int:
    return (num_frames * cfg.frame_num_tokens * len(cfg.v_placeholder)
            + len(cfg.frame_token_interval) * (num_frames - 1))


def render_conversation(
    conversation: Sequence[Message],
    cfg: LiveConfig,
    fmt: ChatFormat,
    *,
    add_generation_prompt: bool = False,
    add_stream_prompt: bool = False,
    add_stream_query_prompt: bool = False,
    add_stream_generation_prompt: bool = False,
) -> str:
    """Render a conversation to the exact reference string layout
    (tokenization_live.py:27-65)."""
    parts: List[str] = []
    messages = list(conversation)
    if messages and messages[0].get("role") == "system":
        parts.append(fmt.bos_token + messages[0]["content"] + "\n")
        messages = messages[1:]
    for m in messages:
        role = m.get("role")
        if role == "user":
            prefix = "]\nUser: " if add_stream_query_prompt else "\nUser: "
            parts.append(prefix + m["content"])
        elif role == "assistant":
            parts.append("\nAssistant: " + m["content"] + fmt.eos_token)
        elif role == "stream" and m.get("num_frames", 0) > 0:
            parts.append("\n[" + stream_placeholder(m["num_frames"], cfg) + "]")
    if add_generation_prompt:
        parts.append("\nAssistant:")
    elif add_stream_prompt:
        parts.append("\n[")
    elif add_stream_generation_prompt:
        parts.append("]\nAssistant:")
    return "".join(parts)


def transition_offsets(fmt: ChatFormat) -> Dict:
    """Character cost of each role transition in the rendered string
    (tokenization_live.py:67-81)."""
    table = {
        (None, "system"): fmt.bos_token,
        ("system", "user"): "\n\nUser: ",
        ("system", "stream"): "\n\n[",
        ("user", "assistant"): "\nAssistant: ",
        ("user", "stream"): "\n[",
        ("user", "user"): "\nUser: ",
        ("assistant", "user"): f"{fmt.eos_token}\nUser: ",
        ("assistant", "stream"): f"{fmt.eos_token}\n[",
        ("stream", "user"): "]\nUser: ",
        ("stream", "assistant"): "]\nAssistant: ",
        "assistant": "Assistant: ",
        "eos_token": fmt.eos_token,
    }
    return {k: len(v) for k, v in table.items()}


def stream_learn_char_ranges(num_frames: int, cfg: LiveConfig) -> List[Tuple[int, int]]:
    """Char spans (relative to the stream placeholder start) to supervise:
    the interval token after each frame, or the last ``<v>`` itself when
    there is no interval (tokenization_live.py:13-25)."""
    per = cfg.frame_num_tokens * len(cfg.v_placeholder) + len(cfg.frame_token_interval)
    len_learn = (len(cfg.frame_token_interval) if cfg.frame_token_interval
                 else len(cfg.v_placeholder))
    out = []
    for i in range(1, num_frames + 1):
        start = per * i - len(cfg.frame_token_interval)
        out.append((start, start + len_learn))
    return out


def get_learn_ranges(conversation: Sequence[Message], cfg: LiveConfig,
                     fmt: ChatFormat) -> List[range]:
    """Character-level supervised ranges over the rendered conversation
    (tokenization_live.py:86-108)."""
    offsets = transition_offsets(fmt)
    offset = 0
    learn: List[range] = []
    last_role = None
    for m in conversation:
        role = m["role"]
        offset += offsets[(last_role, role)]
        last_role = role
        if role == "stream":
            if m.get("learn", False):
                ranges = [(s + offset, e + offset)
                          for s, e in stream_learn_char_ranges(m["num_frames"], cfg)]
                # final frame's span also covers the '\n' after ']'
                s, e = ranges[-1]
                ranges[-1] = (s, e + 1)
                if not isinstance(m["learn"], bool):
                    ranges = ranges[: m["learn"]]
                learn.extend(range(s, e) for s, e in ranges)
            offset += stream_placeholder_len(m["num_frames"], cfg)
        else:
            if role == "assistant" and m.get("learn", False):
                learn.append(range(offset - offsets["assistant"],
                                   offset + len(m["content"]) + offsets["eos_token"]))
            offset += len(m["content"])
    return learn
