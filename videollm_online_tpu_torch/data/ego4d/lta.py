"""Ego4D Long-Term Action Anticipation as language modeling.

Equivalent of reference data/ego4d/lta.py: 8 input actions observed ->
predict the next 20 as a numbered list, 5 beams; verb/noun taxonomy words
de-overlapped; predictions parsed back to (verb, noun) ids with Levenshtein
fuzzy matching; metric = AUED (area under the edit-distance curve,
lta.py:158-191); test-server predictions JSON written on process 0.

A copy of ``videollm_online_tpu/data/ego4d/lta.py``: the port imports
nothing of the JAX package, so it keeps its own."""

from __future__ import annotations

import collections
import itertools
import json
import os
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ...utils.text_metrics import edit_distance_ids, levenshtein
from ..stream import StreamDataset
from ..utils import round_time_by_fps
from .base import Ego4D

NUM_INPUT_ACTIONS = 8
NUM_FUTURE_ACTIONS = 20  # Z
NUM_BEAMS = 5            # K

EVALUATION_KWARGS = {
    "evaluator": "generate", "max_new_tokens": 512, "num_beams": NUM_BEAMS,
    "num_return_sequences": NUM_BEAMS, "do_sample": False, "use_cache": True,
    "temperature": 1.0, "top_p": 1.0,
}

# taxonomy rows with ambiguous parentheticals -> unique single words
_REPLACE = {
    "pot_(planter)": "flowerpot",
    "bat_(sports)": "sport bat",
    "bat_(tool)": "bat",
    "nut_(food)": "nuts",
    "nut_(tool)": "nut",
    "chip_(food)": "snack",
    "chip_(wood'_metal),": "chips",
    "chip_(wood,_metal)": "chip",
}


def split_taxonomy_row(row: str) -> List[str]:
    if "(" not in row:
        return [row.replace("_", " ")]
    head = re.sub(r"_$", "", row.split("(")[0]).replace("_", " ")
    words = [head]
    rest = re.sub(r"[)]", "", row.split("(")[1]).split(",")
    rest = [s.lstrip("_").replace("_", " ") for s in rest]
    words.extend(w for chunk in rest for w in chunk.split("/"))
    return words


def no_overlap_word(row: str) -> str:
    return _REPLACE.get(row, split_taxonomy_row(row)[0])


def user_message(num_frames: int) -> dict:
    return {
        "role": "user",
        "content": (f"After {num_frames} video frames, anticipate the next "
                    f"{NUM_FUTURE_ACTIONS} actions. Format your answer "
                    "concisely, listing each action on a new line with a "
                    "number prefix. No extra text output."),
    }


class Ego4DLTA(Ego4D, StreamDataset):
    evaluation_kwargs = EVALUATION_KWARGS

    def __init__(self, *, split: str, frame_fps: float, is_training: bool,
                 **kwargs):
        super().__init__(frame_fps=frame_fps, is_training=is_training, **kwargs)
        self.split = split

        with open(os.path.join(self.root, "annotations",
                               "fho_lta_taxonomy.json")) as f:
            taxonomy = json.load(f)
        self.verbs = [no_overlap_word(v) for v in taxonomy["verbs"]]
        self.nouns = [no_overlap_word(n) for n in taxonomy["nouns"]]
        self.action_to_verb_label: Dict[str, int] = {}
        self.action_to_noun_label: Dict[str, int] = {}
        counter = collections.defaultdict(int)
        for (i, v), (j, n) in itertools.product(enumerate(self.verbs),
                                                enumerate(self.nouns)):
            action = f"{v} {n}"
            self.action_to_verb_label[action] = i
            self.action_to_noun_label[action] = j
            counter[action] += 1
        self.most_common_action = max(counter, key=counter.get)

        with open(os.path.join(self.root, "annotations",
                               f"fho_lta_{split}.json")) as f:
            raw = json.load(f)["clips"]
        clip2anno = collections.defaultdict(list)
        for a in raw:
            clip2anno[a["clip_uid"]].append({
                "video_uid": a["video_uid"],
                "start": a["clip_parent_start_sec"] + a["action_clip_start_sec"],
                "end": a["clip_parent_start_sec"] + a["action_clip_end_sec"],
                "action_idx": a["action_idx"],
                "verb_label": a.get("verb_label"),
                "noun_label": a.get("noun_label"),
                "clip_uid": a["clip_uid"],
            })
        window = NUM_FUTURE_ACTIONS + NUM_INPUT_ACTIONS
        clip2anno = {c: sorted(v, key=lambda x: x["action_idx"])
                     for c, v in clip2anno.items() if len(v) >= window}

        self.annos = []
        for clip_uid, actions in clip2anno.items():
            for i in range(len(actions) - window + 1):
                video_uid = actions[i]["video_uid"]
                duration = self.metadata[video_uid]["duration"]
                j = i + NUM_INPUT_ACTIONS
                k = i + window
                if "test_unannotated" in split:
                    verb_labels = noun_labels = None
                    response = None
                else:
                    pairs = [(a["verb_label"], a["noun_label"])
                             for a in actions[j:k]]
                    response = self.labels_to_text(pairs)
                    verb_labels, noun_labels = zip(*pairs)
                start_time = round_time_by_fps(actions[i]["start"], frame_fps,
                                               0, duration)
                end_time = round_time_by_fps(actions[j - 1]["end"], frame_fps,
                                             0, duration)
                start_frame = int(start_time * frame_fps)
                stop_frame = int(end_time * frame_fps) + 1
                conversation = [
                    user_message(stop_frame - start_frame),
                    {"role": "stream", "num_frames": stop_frame - start_frame},
                ]
                if is_training:
                    conversation[-1]["learn"] = True
                    conversation.append({"role": "assistant",
                                         "content": response, "learn": True})
                self.annos.append({
                    "conversation": conversation,
                    "add_generation_prompt": not is_training,
                    "load_ranges": {self.metadata[video_uid]["path"]:
                                    range(start_frame, stop_frame)},
                    "verb_labels": verb_labels,
                    "noun_labels": noun_labels,
                    "clip_uid": clip_uid,
                    "last_visible_action_idx": actions[j - 1]["action_idx"],
                })
        self.annos_verb_labels = np.array(
            [a["verb_labels"] for a in self.annos])
        self.annos_noun_labels = np.array(
            [a["noun_labels"] for a in self.annos])

    # -- text <-> labels ------------------------------------------------------
    def labels_to_text(self, pairs: Sequence[Tuple[int, int]]) -> str:
        return "\n".join(
            f"{i + 1}. {self.verbs[v].capitalize()} {self.nouns[n]}."
            for i, (v, n) in enumerate(pairs))

    def _fuzzy_action(self, action: str, table: Dict[str, int]) -> int:
        if action not in table:
            action = min((levenshtein(action, k), k) for k in table)[1]
        return table[action]

    def text_to_verb_noun_ids(self, text: str, num_actions: int
                              ) -> List[Tuple[int, int]]:
        """Parse a numbered action list back to taxonomy ids, padding with
        the last parsed (or the most common) action (lta.py:125-152)."""
        actions = []
        for line in text.strip(" \n").split("\n"):
            m = re.search(r"(?:\d+\.|[^\s]+\s\d+\.)\s*(.*)", line)
            if m:
                actions.append(m.group(1).lower().rstrip("."))
        ids = [(self._fuzzy_action(a, self.action_to_verb_label),
                self._fuzzy_action(a, self.action_to_noun_label))
               for a in actions][:num_actions]
        if len(ids) < num_actions:
            filler = (ids[-1] if ids else
                      (self.action_to_verb_label[self.most_common_action],
                       self.action_to_noun_label[self.most_common_action]))
            ids = ids + [filler] * (num_actions - len(ids))
        return ids

    def __getitem__(self, index):
        anno = self.annos[index]
        return *self.getitem(
            conversation=[dict(m) for m in anno["conversation"]],
            load_ranges=anno["load_ranges"],
            add_generation_prompt=anno["add_generation_prompt"],
        ), index, self.evaluation_kwargs

    # -- metrics --------------------------------------------------------------
    @staticmethod
    def edit_distance(preds: np.ndarray, labels: np.ndarray) -> float:
        """min-over-beams normalized edit distance (lta.py:158-166)."""
        N, K, Z = preds.shape
        return float(np.mean([
            min(edit_distance_ids(preds[n, k], labels[n]) / Z
                for k in range(K))
            for n in range(N)]))

    @staticmethod
    def aued(preds: np.ndarray, labels: np.ndarray) -> float:
        ed = np.stack([Ego4DLTA.edit_distance(preds[:, :, :z], labels[:, :z])
                       for z in range(1, NUM_FUTURE_ACTIONS + 1)])
        return float(np.trapezoid(ed, axis=0) / (NUM_FUTURE_ACTIONS - 1))

    def compute_metrics(self, predictions, sample_idxs, *, tokenizer,
                        output_dir: str = "./", is_main_process: bool = True,
                        **kwargs) -> dict:
        """predictions: (N, beams*len) padded id rows (-100 padding); each
        row reshapes to the 5 returned beams (lta.py:175-201)."""
        batch_verb, batch_noun = [], []
        for row in predictions:
            row = np.asarray(row)
            beams = row[row != -100].reshape(NUM_BEAMS, -1)
            texts = [tokenizer.decode(b, skip_special_tokens=True)
                     for b in beams]
            ids = np.array([self.text_to_verb_noun_ids(t, NUM_FUTURE_ACTIONS)
                            for t in texts])
            batch_verb.append(ids[:, :, 0])
            batch_noun.append(ids[:, :, 1])
        batch_verb = np.stack(batch_verb)
        batch_noun = np.stack(batch_noun)
        if "test_unannotated" not in self.split:
            gt_verb = self.annos_verb_labels[sample_idxs]
            gt_noun = self.annos_noun_labels[sample_idxs]
            return {"verb_AUED": self.aued(batch_verb, gt_verb),
                    "noun_AUED": self.aued(batch_noun, gt_noun)}
        out = {}
        for v, n, idx in zip(batch_verb, batch_noun, sample_idxs):
            a = self.annos[idx]
            out[f"{a['clip_uid']}_{a['last_visible_action_idx']}"] = {
                "verb": v.tolist(), "noun": n.tolist()}
        if is_main_process:
            with open(os.path.join(output_dir,
                                   f"{self.split}_predictions.json"), "w") as f:
                json.dump(out, f)
        return {}


def build_ego4d_lta_train(**kw):
    return Ego4DLTA(split="train", **kw)


def build_ego4d_lta_val(**kw):
    return Ego4DLTA(split="val", **kw)


def build_ego4d_lta_test_unannotated(**kw):
    return Ego4DLTA(split="test_unannotated", **kw)
