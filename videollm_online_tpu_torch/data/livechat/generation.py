"""LiveChat dialogue synthesis from Ego4D GoalStep annotations.

Equivalent of reference data/livechat/ego4d_goalstep_livechat_generation.py:
build a per-video activity transcript from GoalStep segment annotations
(goal + nested step descriptions), sample user queries from the template
bank at random fps-aligned times, and ask an LLM to fill in timestamped
assistant turns, parsed from '{time}s Role: text' lines. 10 conversations
per video by default; pluggable ``generate_fn``.

A copy of ``videollm_online_tpu/data/livechat/generation.py`` (the same
``random`` draws, so a seed gives the same dialogues); ``main`` decodes
through the port's ``make_llama_generate_fn``, on the card unless
``--device cpu`` asks for the CPU."""

from __future__ import annotations

import argparse
import json
import os
import random
import re
from typing import Callable, List, Tuple

from ..utils import ceil_time_by_fps
from .templates import ALL_QUERY_TEMPLATES

LINE_RE = re.compile(r"^\s*(?:\[)?(\d+(?:\.\d+)?)s(?:\])?\s*"
                     r"(User|Assistant)\s*:\s*(.+)$", re.IGNORECASE)


def goalstep_transcripts(anno_root: str, splits=("train", "val")) -> List[dict]:
    """Flatten GoalStep goal/step trees into narration lists
    (reference generation.py:20-37)."""
    annos = []
    for split in splits:
        path = os.path.join(anno_root, f"goalstep_{split}.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            videos = json.load(f)["videos"]
        for v in videos:
            if v.get("segments"):
                annos.append({
                    "video_uid": v["video_uid"],
                    "summary": (v["start_time"], v["end_time"],
                                v["goal_description"].strip()),
                    "narrations": [(s["start_time"], s["end_time"],
                                    s["step_description"].strip())
                                   for s in v["segments"]],
                })
            for seg in v.get("segments", []):
                if seg.get("segments"):
                    annos.append({
                        "video_uid": v["video_uid"],
                        "summary": (seg["start_time"], seg["end_time"],
                                    seg["step_description"].strip()),
                        "narrations": [(s["start_time"], s["end_time"],
                                        s["step_description"].strip())
                                       for s in seg["segments"]],
                    })
    return annos


def build_prompt(narrations: List[Tuple[float, float, str]],
                 queries: List[Tuple[float, str]]) -> str:
    lines = ["A very intelligent multimodal assistant helps the user to do "
             "the following activities:", ""]
    for start, end, text in narrations:
        lines.append(f"{start:.1f}s-{end:.1f}s {text}")
    lines.append("")
    lines.append(
        "Now, please complete the conversation between user and assistant. "
        "The assistant actively provides clear, concise, real-time language "
        "assistance and does not know the absolute time. Sometimes the user "
        "may ask irrelevant questions; the assistant is helpful and will "
        "also answer those. The user asks:")
    for t, q in queries:
        lines.append(f"{t:.1f}s User: {q}")
    lines.append("Respond with one message per line in the format "
                 "'{time}s Assistant: ...' interleaved with the user turns.")
    return "\n".join(lines)


def parse_dialogue(text: str) -> List[dict]:
    """'12.5s Assistant: ...' lines -> conversation messages
    (reference generation.py:88-96)."""
    out = []
    for line in text.splitlines():
        m = LINE_RE.match(line)
        if not m:
            continue
        out.append({"time": float(m.group(1)),
                    "role": m.group(2).lower(),
                    "content": m.group(3).strip()})
    return out


def synthesize(anno_root: str, metadata: dict, generate_fn: Callable[[str], str],
               *, frame_fps: float = 2.0, num_queries: int = 3,
               num_conversations: int = 10, seed: int = 0,
               out_path: str = "goalstep_livechat_trainval.json") -> List[dict]:
    rng = random.Random(seed)
    results = []
    for anno in goalstep_transcripts(anno_root):
        uid = anno["video_uid"]
        if uid not in metadata:
            continue
        duration = metadata[uid]["duration"]
        times = sorted({
            ceil_time_by_fps(t, frame_fps, 0, duration)
            for n in anno["narrations"] for t in n[:2]})
        if len(times) < 2:
            continue
        for _ in range(num_conversations):
            q_times = sorted(rng.sample(times, min(num_queries, len(times))))
            queries = [(t, rng.choice(ALL_QUERY_TEMPLATES)) for t in q_times]
            raw = generate_fn(build_prompt(anno["narrations"], queries))
            conversation = parse_dialogue(raw)
            if conversation:
                results.append({"video_uid": uid,
                                "conversation": conversation})
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    return results


def filter_dialogues(annos: List[dict], *, min_duration: float = 60.0,
                     max_duration: float = 3600.0) -> List[dict]:
    """Drop too-short/too-long dialogues and any that leak time words
    (reference data/livechat/filter.py:10-16)."""
    kept = []
    for anno in annos:
        conv = anno.get("conversation") or []
        if not conv:
            continue
        duration = conv[-1]["time"] - conv[0]["time"]
        if duration < min_duration or duration > max_duration:
            continue
        if any("second" in m["content"] or re.search(r"\b\d+s\b", m["content"])
               for m in conv):
            continue
        anno = dict(anno, duration=duration)
        kept.append(anno)
    return kept


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--anno_root", required=True)
    p.add_argument("--metadata", required=True,
                   help="embed-dir metadata json (video_uid -> duration)")
    p.add_argument("--llm_weights", default="")
    p.add_argument("--tokenizer_path", default="")
    p.add_argument("--out", default="goalstep_livechat_trainval.json")
    p.add_argument("--filtered_out",
                   default="goalstep_livechat_trainval_filtered.json")
    p.add_argument("--device", default="",
                   help="'cpu' for the CPU; the card otherwise")
    a = p.parse_args(argv)
    from ..preprocess.narration_refinement_job import make_llama_generate_fn
    fn = make_llama_generate_fn(a.llm_weights, a.tokenizer_path,
                                max_new_tokens=512, device=a.device or None)
    with open(a.metadata) as f:
        metadata = json.load(f)
    annos = synthesize(a.anno_root, metadata, fn, out_path=a.out)
    kept = filter_dialogues(annos)
    with open(a.filtered_out, "w") as f:
        json.dump(kept, f, indent=1)
    print(f"synthesized {len(annos)}, kept {len(kept)}")


if __name__ == "__main__":
    main()
