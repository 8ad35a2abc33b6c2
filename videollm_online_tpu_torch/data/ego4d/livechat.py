"""Ego4D GoalStep LiveChat: synthesized streaming dialogues.

Equivalent of reference data/ego4d/livechat.py: loads the LLM-synthesized
dialogue JSON (goalstep_livechat_trainval_filtered_21k.json), prepends 0-20
random "waiting" frames before the first user turn, converts wall-clock
message times to the fps grid inserting stream filler turns (user times
floor, assistant times ceil), and marks assistant turns learnable. The
reference's ``preprocess_conversation`` is dead code bypassed by
``__getitem__`` (livechat.py:73-113, SURVEY.md §2) and is intentionally not
reproduced.

A copy of ``videollm_online_tpu/data/ego4d/livechat.py``: the port imports
nothing of the JAX package, so it keeps its own."""

from __future__ import annotations

import json
import os
import random
from typing import List

from ..stream import StreamDataset
from ..utils import ceil_time_by_fps, floor_time_by_fps
from .base import Ego4D

EVALUATION_KWARGS = {"evaluator": "generate"}

DEFAULT_ANNO_NAME = "goalstep_livechat_trainval_filtered_21k.json"


def conversation_from_messages(messages: List[dict], duration: float,
                               fps: float, rng=random):
    """Wall-clock messages -> fps-grid conversation with stream fillers
    (reference livechat.py:22-65). Returns (conversation, start_fps_time) or
    None if the dialogue is unusable."""
    if not messages:
        return None
    first = messages[0]
    if not (first.get("role") == "user" and 0 < first.get("time", 0) <= duration
            and first.get("content")):
        return None
    fps_time = floor_time_by_fps(first["time"], fps, 0, duration)
    waiting = rng.randint(0, min(20, int(fps_time * fps)))
    conversation = []
    if waiting:
        conversation.append({"role": "stream", "num_frames": waiting,
                             "learn": waiting - 1})
    conversation.append({"role": "user", "content": first["content"],
                         "time": first["time"], "fps_time": fps_time})
    start_fps_time = fps_time - (waiting - 1) / fps
    for m in messages[1:]:
        role, content, time = m["role"], m["content"], m["time"]
        if time > duration:
            break
        if time < conversation[-1]["time"]:
            break
        if time == conversation[-1]["time"]:
            if role == "user":
                break
            if conversation[-1]["role"] == "user":
                conversation.append({"role": "assistant", "content": content,
                                     "time": time,
                                     "fps_time": conversation[-1]["fps_time"],
                                     "learn": True})
            else:
                conversation[-1]["content"] = content
            continue
        if role == "user":
            fps_time = floor_time_by_fps(time, fps,
                                         conversation[-1]["fps_time"], duration)
            if fps_time > duration:
                break
            if fps_time > conversation[-1]["fps_time"]:
                conversation.append({
                    "role": "stream",
                    "num_frames": int((fps_time - conversation[-1]["fps_time"]) * fps),
                    "learn": True})
            conversation.append({"role": "user", "content": content,
                                 "time": time, "fps_time": fps_time})
        else:
            fps_time = ceil_time_by_fps(time, fps,
                                        conversation[-1]["fps_time"], duration)
            if fps_time > duration:
                break
            if fps_time > conversation[-1]["fps_time"]:
                conversation.append({
                    "role": "stream",
                    "num_frames": int((fps_time - conversation[-1]["fps_time"]) * fps),
                    "learn": True})
                conversation.append({"role": "assistant", "content": content,
                                     "time": time, "fps_time": fps_time,
                                     "learn": True})
    return (conversation, start_fps_time) if conversation else None


class Ego4DGoalStepLiveChat(Ego4D, StreamDataset):
    evaluation_kwargs = EVALUATION_KWARGS

    def __init__(self, *, frame_fps: float, is_training: bool,
                 anno_path: str = None, **kwargs):
        super().__init__(frame_fps=frame_fps, is_training=is_training, **kwargs)
        anno_path = anno_path or os.path.join(self.anno_root, DEFAULT_ANNO_NAME)
        with open(anno_path) as f:
            raw = json.load(f)
        self.annos = []
        for anno in raw:
            video_uid = anno["video_uid"]
            if video_uid not in self.metadata:
                continue
            duration = self.metadata[video_uid]["duration"]
            result = conversation_from_messages(anno.get("conversation") or [],
                                                duration, frame_fps)
            if result is None:
                continue
            conversation, start_fps_time = result
            self.annos.append({
                "conversation": conversation,
                "load_ranges": {self.metadata[video_uid]["path"]:
                                range(int(start_fps_time * frame_fps),
                                      int(conversation[-1]["fps_time"] * frame_fps) + 1)},
            })

    def __getitem__(self, index):
        anno = self.annos[index]
        return *self.getitem(
            conversation=[dict(m) for m in anno["conversation"]],
            load_ranges=anno["load_ranges"],
        ), index, self.evaluation_kwargs


def build_ego4d_goalstep_livechat_trainval(**kw):
    return Ego4DGoalStepLiveChat(**kw)
