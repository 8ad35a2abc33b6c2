"""StreamDataset: the streaming-dialogue dataset base.

Behavioral equivalent of the reference's StreamMixIn (data/stream.py:6-101):
turns a conversation (system/user/assistant/stream messages) plus a mapping
of feature files -> frame ranges into ``(text, frames, learn_ranges)``.
Includes the stream-dropout augmentation that breaks text-continuation
dependency (data/stream.py:17-72) and the ``max_num_frames`` truncation
(data/stream.py:74-83).

Frames are numpy arrays from the FeatureStore (npy memory-mapped or torch
.pt) — datasets never touch video, matching the reference's pre-extraction
design (SURVEY.md §4).

A copy of ``videollm_online_tpu/data/stream.py``: the port imports nothing
of the JAX package, so it keeps its own."""

from __future__ import annotations

import random
from typing import Dict, List, Union

import numpy as np

from ..tokenizer.live_tokenizer import LiveTokenizer
from .feature_store import load_feature_range
from .utils import rand_bool

Conversation = List[dict]


class StreamDataset:
    def __init__(self, *, is_training: bool, system_prompt: str,
                 augmentation: bool, max_num_frames: int,
                 tokenizer: LiveTokenizer, **kwargs):
        super().__init__()
        assert system_prompt is not None, "a system prompt is required"
        self.is_training = is_training
        self.system_prompt = system_prompt
        self.augmentation = augmentation
        self.max_num_frames = max_num_frames
        self.tokenizer = tokenizer
        self.annos: List[dict] = []

    def __len__(self):
        return len(self.annos)

    # ------------------------------------------------------------ augment
    def augment(self, conversation: Conversation) -> Conversation:
        """Stream-dropout augmentation (reference data/stream.py:17-72).

        Picks a learnable assistant message (never the last) and either
        (a) inserts a wrong/empty answer then a one-frame-later correction,
        (b) delays the answer by one frame, or (c) replaces/unlearns it, so
        the model can't rely on text continuation alone."""
        if not self.augmentation or not self.is_training:
            return conversation
        candidates = [(i, m) for i, m in enumerate(conversation)
                      if m["role"] == "assistant" and m.get("learn", False)]
        if len(candidates) <= 1:
            return conversation
        i, msg = random.choice(candidates[:-1])
        real = msg["content"]
        fakes = list({m["content"] for _, m in candidates
                      if m["content"] != real}) + ["", None]
        fake = random.choice(fakes)
        fake_msg = ({"role": "assistant", "content": fake, "learn": False}
                    if fake is not None else None)
        nxt = conversation[i + 1] if i + 1 < len(conversation) else {}
        prv = conversation[i - 1] if i > 0 else {}

        if rand_bool():  # fix the wrong content at the next frame
            if (fake_msg is not None and nxt.get("role") == "stream"
                    and nxt.get("num_frames", 0) > 1):
                correction = {
                    "role": "assistant",
                    "content": f"(Sorry, the last response is wrong) {real}",
                    "learn": True,
                }
                return (conversation[:i]
                        + [fake_msg,
                           {"role": "stream", "num_frames": 1, "learn": True},
                           correction,
                           {"role": "stream",
                            "num_frames": nxt["num_frames"] - 1, "learn": True}]
                        + conversation[i + 2:])
            if (fake_msg is None and prv.get("role") == "stream"
                    and nxt.get("role") == "stream"
                    and nxt.get("num_frames", 0) > 1):
                return (conversation[:i - 1]
                        + [{"role": "stream",
                            "num_frames": prv["num_frames"] + 1,
                            "learn": prv["num_frames"] - 1},
                           {"role": "assistant", "content": real, "learn": True},
                           {"role": "stream",
                            "num_frames": nxt["num_frames"] - 1, "learn": True}]
                        + conversation[i + 2:])
            return conversation
        # not fixed
        if fake_msg is not None:
            if nxt.get("role") == "stream":
                return (conversation[:i]
                        + [fake_msg,
                           {"role": "stream", "num_frames": nxt["num_frames"],
                            "learn": False}]
                        + conversation[i + 2:])
            return conversation[:i] + [fake_msg] + conversation[i + 1:]
        if prv.get("role") == "stream":
            if nxt.get("role") != "stream":
                return (conversation[:i - 1]
                        + [{"role": "stream", "num_frames": prv["num_frames"],
                            "learn": prv["num_frames"] - 1}]
                        + conversation[i + 1:])
            return (conversation[:i - 1]
                    + [{"role": "stream",
                        "num_frames": prv["num_frames"] + nxt["num_frames"],
                        "learn": prv["num_frames"] - 1}]
                    + conversation[i + 2:])
        if nxt.get("role") == "stream":
            return (conversation[:i]
                    + [{"role": "stream", "num_frames": nxt["num_frames"],
                        "learn": False}]
                    + conversation[i + 2:])
        return conversation[:i] + conversation[i + 1:]

    # ----------------------------------------------------------- truncate
    def max_frames_clip(self, conversation: Conversation,
                        load_ranges: Dict[str, range],
                        max_num_frames: int):
        """Drop conversation tail once the cumulative stream length exceeds
        the budget (reference data/stream.py:74-83)."""
        cum = 0
        for i, m in enumerate(conversation):
            if m["role"] == "stream":
                if cum + m["num_frames"] > max_num_frames:
                    conversation = conversation[:i]
                    load_ranges = {p: range(r.start, r.start + cum)
                                   for p, r in load_ranges.items()}
                    break
                cum += m["num_frames"]
        return conversation, load_ranges

    # ------------------------------------------------------------ getitem
    def getitem(self, *, conversation: Conversation,
                load_ranges: Union[Dict[str, range], np.ndarray, None] = None,
                add_generation_prompt: bool = False, **kwargs):
        if isinstance(load_ranges, np.ndarray):
            frames = load_ranges
        elif load_ranges is not None:
            conversation, load_ranges = self.max_frames_clip(
                conversation, load_ranges, self.max_num_frames)
            frames = np.concatenate([load_feature_range(path, r)
                                     for path, r in load_ranges.items()])
        else:
            frames = np.zeros((0,), np.float32)
        if self.augmentation:
            conversation = self.augment(conversation)
        conversation = ([{"role": "system", "content": self.system_prompt}]
                        + conversation)
        text = self.tokenizer.apply_chat_template(
            conversation, add_generation_prompt=add_generation_prompt)
        learn_ranges = (self.tokenizer.get_learn_ranges(conversation)
                        if not add_generation_prompt else [])
        return text, frames, learn_ranges
