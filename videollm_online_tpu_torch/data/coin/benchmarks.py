"""COIN benchmark datasets: step / next / task / procedure / task-procedure.

Equivalent of reference data/coin/benchmarks.py: each benchmark emits
``user prompt -> stream(step window) -> assistant answer`` samples; at eval
the assistant turn is dropped and generation is scored by accuracy with
Levenshtein fuzzy matching against the closed category set (benchmarks.py:
12-25). Evaluator is 'generate_after_embed' (greedy decode from the jointly
embedded prompt, modeling_live_llama.py:69-70).

A copy of ``videollm_online_tpu/data/coin/benchmarks.py``: the port imports
nothing of the JAX package, so it keeps its own."""

from __future__ import annotations

from typing import List

import numpy as np

from ...utils.text_metrics import fuzzy_match
from ..stream import StreamDataset
from ..utils import ceil_time_by_fps
from .base import COIN

MAX_NUM_STEPS = 5

EVALUATION_KWARGS = {
    "evaluator": "generate_after_embed", "max_new_tokens": 512,
    "do_sample": False, "use_cache": True, "temperature": 1.0, "top_p": 1.0,
}

STEP_PROMPT = ("What is the action in the video? Format your answer "
               "concisely. No extra text output.")
NEXT_PROMPT = ("What is the next action for the video? Format your answer "
               "concisely. No extra text output.")
TASK_PROMPT = ("What is the overall activity in the video? Format your "
               "answer concisely. No extra text output.")


def procedure_prompt(num_steps: int) -> str:
    return (f"What is the next {num_steps} actions for the video? Format "
            "your answer concisely, listing each action on a new line with "
            "a number prefix. No extra text output.")


def task_single_prompt(task: str) -> str:
    return (f"To {task}, what is the next action for the video? Format your "
            "answer concisely. No extra text output.")


def task_multi_prompt(task: str, num_steps: int) -> str:
    return (f"To {task}, what is the next {num_steps} actions for the video? "
            "Format your answer concisely, listing each action on a new line "
            "with a number prefix. No extra text output.")


def _frame_window(step_start, step_end, duration, fps):
    start_time = ceil_time_by_fps(step_start, fps, 0, duration)
    end_time = ceil_time_by_fps(step_end, fps, 0, duration)
    return int(start_time * fps), int(end_time * fps) + 1


class COINBenchmark(COIN, StreamDataset):
    evaluation_kwargs = EVALUATION_KWARGS

    def _add(self, video_uid, prompt, start_frame, end_frame, response):
        self.annos.append({
            "conversation": [
                {"role": "user", "content": prompt},
                {"role": "stream", "num_frames": end_frame - start_frame,
                 "learn": True},
                {"role": "assistant", "content": response, "learn": True},
            ],
            "load_ranges": {self.metadata[video_uid]["path"]:
                            range(start_frame, end_frame)},
        })

    def __getitem__(self, index):
        anno = self.annos[index]
        conversation = [dict(m) for m in anno["conversation"]]
        if not self.is_training:  # drop the answer; ask for generation
            conversation = conversation[:-1]
        return *self.getitem(
            conversation=conversation,
            load_ranges=anno["load_ranges"],
            add_generation_prompt=not self.is_training,
        ), index, self.evaluation_kwargs

    def compute_metrics(self, predictions, sample_idxs, *, tokenizer,
                        **kwargs) -> dict:
        """Accuracy with fuzzy category matching (benchmarks.py:16-25).
        ``predictions``: (N, L) generated id rows (negative = padding)."""
        correct = 0
        texts = self._decode_predictions(predictions, tokenizer)
        for text, label in zip(texts, self.labels[np.asarray(sample_idxs)]):
            text = text.lower().rstrip(".")
            if text == label or fuzzy_match(text, self.categories) == label:
                correct += 1
        return {"accuracy": correct / len(texts) * 100}

    @staticmethod
    def _decode_predictions(predictions, tokenizer) -> List[str]:
        rows = np.asarray(predictions).copy()
        # negative padding -> bos (not 0: token 0 is '!' in Llama-3 and
        # would perturb matching; benchmarks.py:18)
        rows[rows < 0] = tokenizer.cfg.bos_token_id or 0
        return [tokenizer.decode(r, skip_special_tokens=True) for r in rows]


class COINStep(COINBenchmark):
    def __init__(self, *, split, frame_fps, is_training, **kwargs):
        super().__init__(split=split, frame_fps=frame_fps,
                         is_training=is_training, **kwargs)
        self.annos, labels = [], []
        for anno in self._annos:
            duration = self.metadata[anno["video_uid"]]["duration"]
            for step in anno["steps"]:
                labels.append(step["text"].lower())
                sf, ef = _frame_window(step["start"], step["end"], duration,
                                       frame_fps)
                self._add(anno["video_uid"], STEP_PROMPT, sf, ef,
                          step["text"].capitalize() + ".")
        self.labels = np.array(labels)
        self.categories = self.step_categories


class COINNext(COINBenchmark):
    def __init__(self, *, split, frame_fps, is_training, **kwargs):
        super().__init__(split=split, frame_fps=frame_fps,
                         is_training=is_training, **kwargs)
        self.annos, labels = [], []
        for anno in self._annos:
            duration = self.metadata[anno["video_uid"]]["duration"]
            steps = anno["steps"]
            for i in range(len(steps) - 1):
                labels.append(steps[i + 1]["text"].lower())
                sf, ef = _frame_window(steps[i]["start"], steps[i]["end"],
                                       duration, frame_fps)
                self._add(anno["video_uid"], NEXT_PROMPT, sf, ef,
                          steps[i + 1]["text"].capitalize() + ".")
        self.labels = np.array(labels)
        self.categories = self.step_categories


class COINTask(COINBenchmark):
    def __init__(self, *, split, frame_fps, is_training, **kwargs):
        super().__init__(split=split, frame_fps=frame_fps,
                         is_training=is_training, **kwargs)
        self.annos, labels = [], []
        for anno in self._annos:
            duration = self.metadata[anno["video_uid"]]["duration"]
            labels.append(anno["task"].lower())
            sf, ef = _frame_window(anno["start"], anno["end"], duration,
                                   frame_fps)
            self._add(anno["video_uid"], TASK_PROMPT, sf, ef,
                      anno["task"].capitalize() + ".")
        self.labels = np.array(labels)
        self.categories = self.task_categories


class _ProcedureMixin:
    """Shared next-K-steps sample construction + line-wise accuracy."""

    def _build_procedure(self, frame_fps, prompt_single, prompt_multi):
        self.annos, self.labels = [], []
        for anno in self._annos:
            duration = self.metadata[anno["video_uid"]]["duration"]
            steps = anno["steps"]
            for i in range(len(steps) - 1):
                sf, ef = _frame_window(steps[i]["start"], steps[i]["end"],
                                       duration, frame_fps)
                next_steps = steps[i + 1:i + MAX_NUM_STEPS + 1]
                if len(next_steps) == 1:
                    prompt = prompt_single(anno)
                    response = next_steps[0]["text"].capitalize() + "."
                else:
                    prompt = prompt_multi(anno, len(next_steps))
                    response = "\n".join(
                        f"{j + 1}. {s['text'].capitalize()}."
                        for j, s in enumerate(next_steps))
                self.labels.append([s["text"].lower() for s in next_steps])
                self._add(anno["video_uid"], prompt, sf, ef, response)
        self.categories = self.step_categories

    def compute_metrics(self, predictions, sample_idxs, *, tokenizer,
                        **kwargs) -> dict:
        """Per-line step accuracy (benchmarks.py:190-202)."""
        texts = COINBenchmark._decode_predictions(predictions, tokenizer)
        correct = total = 0
        for text, label_steps in zip(
                texts, (self.labels[i] for i in np.asarray(sample_idxs))):
            for line, label in zip(text.split("\n"), label_steps):
                line = line.split(". ")[-1]
                if line == label or fuzzy_match(line, self.categories) == label:
                    correct += 1
                total += 1
        return {"accuracy": correct / total * 100}


class COINProcedure(_ProcedureMixin, COINBenchmark):
    def __init__(self, *, split, frame_fps, is_training, **kwargs):
        super().__init__(split=split, frame_fps=frame_fps,
                         is_training=is_training, **kwargs)
        self._build_procedure(
            frame_fps,
            prompt_single=lambda anno: NEXT_PROMPT,
            prompt_multi=lambda anno, n: procedure_prompt(n))


class COINTaskProcedure(_ProcedureMixin, COINBenchmark):
    def __init__(self, *, split, frame_fps, is_training, **kwargs):
        super().__init__(split=split, frame_fps=frame_fps,
                         is_training=is_training, **kwargs)
        self._build_procedure(
            frame_fps,
            prompt_single=lambda anno: task_single_prompt(anno["task"]),
            prompt_multi=lambda anno, n: task_multi_prompt(anno["task"], n))


def build_coin_step_train(**kw): return COINStep(split="train", **kw)
def build_coin_step_test(**kw): return COINStep(split="test", **kw)
def build_coin_next_train(**kw): return COINNext(split="train", **kw)
def build_coin_next_test(**kw): return COINNext(split="test", **kw)
def build_coin_task_train(**kw): return COINTask(split="train", **kw)
def build_coin_task_test(**kw): return COINTask(split="test", **kw)
def build_coin_procedure_train(**kw): return COINProcedure(split="train", **kw)
def build_coin_procedure_test(**kw): return COINProcedure(split="test", **kw)
def build_coin_taskprocedure_train(**kw): return COINTaskProcedure(split="train", **kw)
def build_coin_taskprocedure_test(**kw): return COINTaskProcedure(split="test", **kw)
