"""Ego4D NLQ (natural-language query temporal grounding) as streaming.

Equivalent of reference data/ego4d/nlq.py: per-query overlapping regions are
IoU-merged; each region becomes ``stream -> "...starts." -> stream ->
"...ends."``; 10 query prompt paraphrases; evaluated with stream_evaluate.

A copy of ``videollm_online_tpu/data/ego4d/nlq.py``: the port imports
nothing of the JAX package, so it keeps its own."""

from __future__ import annotations

import collections
import json
import os
import random
from typing import Dict, List, Tuple

import numpy as np

from ..stream import StreamDataset
from ..utils import ceil_time_by_fps, temporal_iou
from .base import Ego4D
from .narration import EVALUATION_KWARGS as STREAM_EVALUATION_KWARGS

QUERY_PROMPT_TEMPLATES = [
    'Locate video clips related to the query "QUERY".',
    'Remind me when the query "QUERY".',
    'When query "QUERY" starts and ends, remind me.',
    'Do temporal grounding to query "QUERY".',
    'Can you locate query "QUERY" in the video?',
    'Record when query "QUERY".',
    'Please find the period of query "QUERY".',
    'Retrieve query "QUERY".',
    'Identify the start and end times of query "QUERY" in the video.',
    'Show me the video segment where query "QUERY" takes place.',
]


def merge_query_regions(raw_annos: dict) -> Dict[Tuple, List[List[float]]]:
    """(video_uid, clip_start, clip_end, query) -> sorted merged regions
    (reference nlq.py:13-39)."""
    merged: Dict[Tuple, List[List[float]]] = collections.defaultdict(list)
    for video in raw_annos["videos"]:
        video_uid = video["video_uid"]
        for clip in video["clips"]:
            cs, ce = clip["video_start_sec"], clip["video_end_sec"]
            for annos in clip["annotations"]:
                for q in annos["language_queries"]:
                    if q.get("query"):
                        query = q["query"].lower()
                    elif q.get("slot_x"):
                        query = q["slot_x"].lower()
                    else:
                        continue
                    key = (video_uid, cs, ce, query)
                    qs, qe = q["video_start_sec"], q["video_end_sec"]
                    regions = merged[key]
                    for region in regions:
                        if temporal_iou(region, [qs, qe]) > 0:
                            region[0] = min(region[0], qs)
                            region[1] = max(region[1], qe)
                            break
                    else:
                        regions.append([qs, qe])
    return {k: sorted(v, key=lambda x: x[0]) for k, v in merged.items()}


class Ego4DStreamNLQ(Ego4D, StreamDataset):
    evaluation_kwargs = STREAM_EVALUATION_KWARGS

    def __init__(self, *, split: str, frame_fps: float, **kwargs):
        assert split in ("train", "val", "test")
        super().__init__(frame_fps=frame_fps, **kwargs)
        self.split = split
        with open(os.path.join(self.root, "annotations",
                               f"nlq_{split}.json")) as f:
            merged = merge_query_regions(json.load(f))
        self.annos = []
        for (video_uid, vstart, vend, query), regions in merged.items():
            if video_uid not in self.metadata:
                continue
            duration = self.metadata[video_uid]["duration"]
            if vstart > duration or vend > duration:
                continue
            vend = ceil_time_by_fps(vend, frame_fps, 0, duration)
            vstart = ceil_time_by_fps(vstart, frame_fps, 0, vend)
            conversation = []
            last_time = vstart - 1 / frame_fps
            for qs, qe in regions:
                qs = ceil_time_by_fps(qs, frame_fps, last_time + 1 / frame_fps,
                                      vend)
                qe = ceil_time_by_fps(qe, frame_fps, qs, vend)
                if int((qs - last_time) * frame_fps) <= 0:
                    break
                if int((qe - qs) * frame_fps) <= 0:
                    break
                conversation.extend([
                    {"role": "stream",
                     "num_frames": int((qs - last_time) * frame_fps),
                     "learn": True},
                    {"role": "assistant",
                     "content": f'The video related to the query "{query}" starts.',
                     "learn": True},
                    {"role": "stream",
                     "num_frames": int((qe - qs) * frame_fps), "learn": True},
                    {"role": "assistant",
                     "content": f'The video related to the query "{query}" ends.',
                     "learn": True},
                ])
                last_time = qe
            if not conversation:
                continue
            self.annos.append({
                "query": query,
                "conversation": conversation,
                "load_ranges": {self.metadata[video_uid]["path"]:
                                range(int(vstart * frame_fps),
                                      int(last_time * frame_fps) + 1)},
            })

    def preprocess_conversation(self, conversation, query):
        prompt = random.choice(QUERY_PROMPT_TEMPLATES).replace("QUERY", query)
        return [{"role": "user", "content": prompt}] + conversation

    def __getitem__(self, index):
        anno = self.annos[index]
        return *self.getitem(
            conversation=self.preprocess_conversation(
                [dict(m) for m in anno["conversation"]], anno["query"]),
            load_ranges=anno["load_ranges"],
        ), index, self.evaluation_kwargs

    def compute_metrics(self, predictions, sample_idxs=None, **kwargs):
        lm_ppl, frame_diff, fluency, lm_correctness = np.mean(
            np.asarray(predictions, np.float64), axis=0).tolist()
        return {"lm_ppl": lm_ppl, "time_diff": frame_diff / self.frame_fps,
                "fluency": fluency, "lm_correctness": lm_correctness}


def build_ego4d_nlq_stream_train(**kw):
    return Ego4DStreamNLQ(split="train", **kw)


def build_ego4d_nlq_stream_val(**kw):
    return Ego4DStreamNLQ(split="val", **kw)


def build_ego4d_nlq_stream_test_unannotated(**kw):
    return Ego4DStreamNLQ(split="test", **kw)
