"""Ego4D narration-stream datasets (dense real-time narration).

Equivalent of reference data/ego4d/narration.py: timestamped narrations
become alternating ``stream``/``assistant`` turns on the fps grid
(ceil_time_by_fps alignment); benchmark val/test video uids are excluded
from train; ``#C/#O/#unsure`` tags are stripped. Metrics: LM-PPL,
TimeDiff (= frame_diff / fps), Fluency, LM-Correctness via stream_evaluate
(narration.py:132-139).

A copy of ``videollm_online_tpu/data/ego4d/narration.py``: the port imports
nothing of the JAX package, so it keeps its own."""

from __future__ import annotations

import collections
import json
import os
import random
from typing import Dict, List

import numpy as np

from ..stream import StreamDataset
from ..utils import ceil_time_by_fps
from .base import Ego4D

EVALUATION_KWARGS = {"evaluator": "stream_evaluate"}

NARRATION_INSTRUCTION = {
    "role": "user",
    "content": ("Please concisely narrate the video in real time. Use the "
                "tag 'C' to denote the camera wearer, and other letter tags, "
                "such as 'X', to denote other individuals in the scene."),
}

# benchmark annotation files whose val/test uids are excluded from train
BENCHMARK_SPLIT_KEYS = {
    "goalstep": "videos", "fho_lta": "clips", "nlq": "videos",
    "moments": "videos", "av": "videos", "fho_oscc-pnr": "clips",
    "fho_sta": "annotations", "vq": "videos",
}


def clean_narration_text(src: str) -> str:
    """Strip annotation tags and normalize (reference narration.py:117-130)."""
    dst = src
    for tag in ("#C", "#c", "@c", "#O", "#o", "#Unsure", "#unsure", "#"):
        dst = dst.replace(tag, "")
    dst = dst.strip(".,\n ") + "."
    words = dst.split()
    words[0] = words[0].capitalize()
    return " ".join(words)


class Ego4DNarrationStream(Ego4D, StreamDataset):
    instructions = [NARRATION_INSTRUCTION]
    evaluation_kwargs = EVALUATION_KWARGS

    def __init__(self, *, split: str, frame_fps: float, is_training: bool,
                 **kwargs):
        super().__init__(frame_fps=frame_fps, is_training=is_training, **kwargs)
        self.split = split
        streams = self._load_streams(split)
        self.annos = []
        for video_uid, by_annotation_uid in streams.items():
            duration = self.metadata[video_uid]["duration"]
            for narrations in by_annotation_uid.values():
                anno = self._narrations_to_anno(video_uid, narrations,
                                                duration, frame_fps)
                if anno is not None:
                    self.annos.append(anno)

    # -- annotation ingestion ------------------------------------------------
    def _load_streams(self, split: str) -> Dict[str, Dict[str, List[dict]]]:
        """video_uid -> annotation_uid -> sorted cleaned narrations.
        Uses cached ``narration_stream_{split}.json`` when present; otherwise
        derives the split by excluding benchmark val/test uids
        (narration.py:16-63)."""
        cached = os.path.join(self.anno_root, f"narration_stream_{split}.json")
        if os.path.exists(cached):
            with open(cached) as f:
                return json.load(f)
        with open(os.path.join(self.anno_root,
                               "all_narrations_redacted.json")) as f:
            all_annos = json.load(f)["videos"]
        uids_path = os.path.join(self.anno_root,
                                 f"narration_stream_video_uids_{split}.json")
        if os.path.exists(uids_path):
            with open(uids_path) as f:
                split_uids = json.load(f)
        else:
            val_uids, test_uids = set(), set()
            for benchmark, key in BENCHMARK_SPLIT_KEYS.items():
                for suffix, bucket in (("val", val_uids),
                                       ("test_unannotated", test_uids)):
                    p = os.path.join(self.root, "annotations",
                                     f"{benchmark}_{suffix}.json")
                    with open(p) as f:
                        bucket.update(a["video_uid"] for a in json.load(f)[key])
            test_uids -= val_uids
            all_uids = set(all_annos.keys())
            split_uids = {
                "train": list(all_uids - val_uids - test_uids),
                "val": list(all_uids & val_uids),
                "test": list(all_uids & test_uids),
            }[split]
            with open(uids_path, "w") as f:
                json.dump(split_uids, f, indent=4)
        streams: Dict[str, Dict[str, List[dict]]] = {}
        for video_uid in split_uids:
            anno = all_annos[video_uid]
            narrations = []
            for ns in anno["narrations"]:
                text = clean_narration_text(ns["text"])
                if len(text.split(" ")) >= 2:  # at least "C verb."
                    narrations.append({"time": ns["time"], "text": text,
                                       "_uid": ns["_annotation_uid"]})
            narrations.sort(key=lambda x: x["time"])
            grouped = collections.defaultdict(list)
            for n in narrations:
                grouped[n.pop("_uid")].append(n)
            streams[video_uid] = dict(grouped)
        with open(cached, "w") as f:
            json.dump(streams, f, indent=4)
        return streams

    def _narrations_to_anno(self, video_uid, narrations, duration, fps):
        """Timestamped narrations -> fps-aligned stream/assistant turns
        (narration.py:77-106)."""
        if not narrations:
            return None
        start_time = ceil_time_by_fps(narrations[0]["time"], fps, 0, duration)
        conversation = []
        last_time = start_time - 1 / fps
        last_text = None
        for n in narrations:
            if last_time >= duration:
                break
            text = n["text"]
            if text == last_text:
                continue
            time = ceil_time_by_fps(n["time"], fps, 0, duration)
            if time == last_time:
                conversation[-1]["content"] = text  # later one wins the slot
            else:
                conversation.extend([
                    {"role": "stream",
                     "num_frames": int((time - last_time) * fps),
                     "learn": True},
                    {"role": "assistant", "content": text, "learn": True},
                ])
            last_time = time
            last_text = text
        if not conversation:
            return None
        return {
            "conversation": conversation,
            "load_ranges": {self.metadata[video_uid]["path"]:
                            range(int(start_time * fps),
                                  int(last_time * fps) + 1)},
        }

    def preprocess_conversation(self, conversation):
        """First stream frame carries the instruction (narration.py:108-111)."""
        assert conversation[0]["role"] == "stream"
        first = dict(conversation[0], learn=False)
        return [first, random.choice(self.instructions)] + conversation[1:]

    def __getitem__(self, index):
        anno = self.annos[index]
        return *self.getitem(
            conversation=self.preprocess_conversation(
                [dict(m) for m in anno["conversation"]]),
            load_ranges=anno["load_ranges"],
        ), index, self.evaluation_kwargs

    def compute_metrics(self, predictions: np.ndarray, sample_idxs=None,
                        **kwargs) -> dict:
        """predictions: (N, 4) rows of [lm_ppl, frame_diff, fluency,
        lm_correctness] from stream_evaluate (narration.py:132-139)."""
        lm_ppl, frame_diff, fluency, lm_correctness = np.mean(
            np.asarray(predictions, np.float64), axis=0).tolist()
        return {
            "lm_ppl": lm_ppl,
            "time_diff": frame_diff / self.frame_fps,
            "fluency": fluency,
            "lm_correctness": lm_correctness,
        }


REFINED_INSTRUCTIONS = [
    {"role": "user", "content": c} for c in (
        "Please concisely narrate the video in real time.",
        "Help me to illustrate my view in short.",
        "Please simply describe what do you see.",
        "Continuously answer what you observed with simple text.",
        "Do concise real-time narration.",
        "Hey assistant, do you know the current video content? Reply me concisely.",
        "Simply interpret the scene for me.",
        "What can you tell me about? Be concise.",
        "Use simple text to explain what is shown in front of me.",
        "What is the action now? Please response in short.",
    )
]


class Ego4DRefinedNarrationStream(Ego4DNarrationStream):
    """Same stream structure over LLM-refined annotations
    ('[C looks around.]' -> '[You look around.]'; narration.py:147-165),
    with 10 instruction paraphrases."""

    instructions = REFINED_INSTRUCTIONS

    def _load_streams(self, split: str):
        path = os.path.join(self.anno_root,
                            f"refined_narration_stream_{split}.json")
        with open(path) as f:
            return json.load(f)


def build_ego4d_narration_stream_train(**kw):
    return Ego4DNarrationStream(split="train", **kw)


def build_ego4d_narration_stream_val(**kw):
    return Ego4DNarrationStream(split="val", **kw)


def build_ego4d_narration_stream_test(**kw):
    return Ego4DNarrationStream(split="test", **kw)


def build_ego4d_refined_narration_stream_train(**kw):
    return Ego4DRefinedNarrationStream(split="train", **kw)


def build_ego4d_refined_narration_stream_val(**kw):
    return Ego4DRefinedNarrationStream(split="val", **kw)


def build_ego4d_refined_narration_stream_test(**kw):
    return Ego4DRefinedNarrationStream(split="test", **kw)
