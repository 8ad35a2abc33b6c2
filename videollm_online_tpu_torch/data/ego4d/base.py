"""Ego4D dataset base: roots, embed-dir naming, lazy video metadata.

Equivalent of reference data/ego4d/ego4d.py: the embedding directory is
``{video_root}_{embed_mark}_{vision_pretrained with / -> --}`` and a
``*_metadata.json`` maps video_uid -> {duration, path}, built lazily by
reading feature-file lengths ((len - 1) / fps). Roots are parameterizable
(the reference hard-codes them) so tests can point at synthetic trees.

A copy of ``videollm_online_tpu/data/ego4d/base.py``: the port imports
nothing of the JAX package, so it keeps its own."""

from __future__ import annotations

import json
import os
from typing import Dict

from ..feature_store import feature_len


class Ego4D:
    root = os.environ.get("EGO4D_ROOT", "datasets/ego4d/v2")

    def __init__(self, *, vision_pretrained: str, embed_mark: str,
                 frame_fps: float, root: str = None, **kwargs):
        super().__init__(**kwargs)
        self.root = root or Ego4D.root
        self.video_root = os.path.join(self.root, "full_scale")
        self.anno_root = os.path.join(self.root, "annotations")
        self.embed_dir = (f"{self.video_root}_{embed_mark}_"
                          f"{vision_pretrained.replace('/', '--')}")
        self.frame_fps = frame_fps
        self.metadata = self.get_metadata()

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
