"""COIN instructional-video dataset base.

Equivalent of reference data/coin/coin.py: loads coin.json's database,
filters by split + available features, cleans step/task text (CamelCase task
names -> spaced lowercase with acronym fixes), exposes task/step category
sets and lazy per-video metadata.

A copy of ``videollm_online_tpu/data/coin/base.py``: the port imports
nothing of the JAX package, so it keeps its own."""

from __future__ import annotations

import json
import os
from typing import Dict

from ..feature_store import feature_len

_STEP_REPLACES = {
    "process (crop, fold) paper": "crop and fold paper",
    "try to press gun head, spray residual old grease":
        "try to press gun head to spray residual old grease",
}

_ACRONYMS = [(" t v", " TV"), (" c d", " CD"), ("s i m", "SIM"),
             ("n b a", "NBA"), ("s s d", "SSD"), ("r j45", "RJ45")]


def clean_step(step: str) -> str:
    return _STEP_REPLACES.get(step, step)


def clean_task(text: str) -> str:
    """PutOnHair -> 'put on hair', with acronym fixes (coin.py:44-67)."""
    out = []
    for ch in text:
        if ch.isupper():
            out.append(" " + ch.lower())
        else:
            out.append(ch)
    result = "".join(out)
    for src, dst in _ACRONYMS:
        result = result.replace(src, dst)
    return result.strip()


class COIN:
    root = os.environ.get("COIN_ROOT", "datasets/coin")

    def __init__(self, *, split: str, vision_pretrained: str, embed_mark: str,
                 frame_fps: float, root: str = None, **kwargs):
        super().__init__(**kwargs)
        assert split in ("train", "test")
        self.root = root or COIN.root
        self.video_root = os.path.join(self.root, "videos")
        self.embed_dir = (f"{self.video_root}_{embed_mark}_"
                          f"{vision_pretrained.replace('/', '--')}")
        self.frame_fps = frame_fps
        self.metadata = self.get_metadata()
        with open(os.path.join(self.root, "coin.json")) as f:
            database = json.load(f)["database"]
        self._annos = [{
            "video_uid": uid,
            "task": clean_task(anno["class"]),
            "start": anno["start"],
            "end": anno["end"],
            "steps": [{"start": s["segment"][0], "end": s["segment"][1],
                       "text": clean_step(s["label"])}
                      for s in anno["annotation"]],
        } for uid, anno in database.items()
            if split in anno["subset"].lower() and uid in self.metadata]
        self.task_categories = list({a["task"].lower() for a in self._annos})
        self.step_categories = list({s["text"].lower()
                                     for a in self._annos for s in a["steps"]})

    def get_metadata(self) -> Dict[str, dict]:
        metadata_path = f"{self.embed_dir}_metadata.json"
        if os.path.exists(metadata_path):
            with open(metadata_path) as f:
                return json.load(f)
        metadata = {}
        for file in os.listdir(self.embed_dir):
            path = os.path.join(self.embed_dir, file)
            duration = (feature_len(path) - 1) / self.frame_fps
            key = os.path.splitext(os.path.basename(path))[0]
            metadata[key] = {"duration": duration, "path": path}
        with open(metadata_path, "w") as f:
            json.dump(metadata, f, indent=4)
        return metadata

    def __len__(self):
        return len(self.annos)
