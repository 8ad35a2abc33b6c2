"""Robustness dataset: hard-coded refusal conversations.

Equivalent of reference data/robustness.py: five conversations teaching
no-video / noise-frame / black-frame refusals; noise and zero frame
features are injected directly as arrays (the reference uses
torch.rand/zeros, data/robustness.py:36,43).

A copy of ``videollm_online_tpu/data/robustness.py``: the port imports
nothing of the JAX package, so it keeps its own."""

from __future__ import annotations

import numpy as np

from .stream import StreamDataset


class Robustness(StreamDataset):
    def __init__(self, *, vision_hidden_size: int = 1024, seed: int = 0,
                 **kwargs):
        kwargs.pop("vision_pretrained", None)
        kwargs.pop("embed_mark", None)
        kwargs.pop("frame_fps", None)
        super().__init__(**kwargs)
        rng = np.random.RandomState(seed)
        self.annos = [
            {
                "conversation": [
                    {"role": "user", "content": "Please help me to narrate the video in real time."},
                    {"role": "assistant", "content": "Sure! Please provide me the video stream, and I will help you.", "learn": True},
                ],
                "load_ranges": None,
            },
            {
                "conversation": [
                    {"role": "user", "content": "Concisely output what you have seen."},
                    {"role": "assistant", "content": "Sure! Please provide me the video inputs.", "learn": True},
                ],
                "load_ranges": None,
            },
            {
                "conversation": [
                    {"role": "user", "content": "..."},
                    {"role": "assistant", "content": "Hi! How can I help you?", "learn": True},
                ],
                "load_ranges": None,
            },
            {
                "conversation": [
                    {"role": "stream", "num_frames": 10, "learn": False},
                    {"role": "user", "content": "What is happening now?", "learn": False},
                    {"role": "assistant", "content": "Sorry, it seems the input video frames are noise. Could you have a check?", "learn": True},
                ],
                # noise features; broadcast over the 10 frames by joint_embed
                "load_ranges": rng.rand(1, vision_hidden_size).astype(np.float32),
            },
            {
                "conversation": [
                    {"role": "stream", "num_frames": 1, "learn": False},
                    {"role": "user", "content": "What is the next step?", "learn": False},
                    {"role": "assistant", "content": "Sorry, I cannot see anything in the input video frame. Could you check it?", "learn": True},
                ],
                "load_ranges": np.zeros((1, vision_hidden_size), np.float32),
            },
        ]

    def __getitem__(self, index):
        anno = self.annos[index]
        return *self.getitem(conversation=[dict(m) for m in anno["conversation"]],
                             load_ranges=anno["load_ranges"]), index, {}


def build_robustness(**kwargs):
    return Robustness(**kwargs)
