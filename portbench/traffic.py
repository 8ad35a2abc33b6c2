"""The one traffic generator: it reads a mix's parameters (``traffic/*.json``)
and makes the same inputs from the same seed.

Serving: each of ``streams`` streams plays videos back to back, every frame
of a video queued at once (a closed backlog). A video's length and the
stream's entry point into its first video are drawn from a stratified set
that every seed shares, dealt to the streams in a seeded order, so seeds
change the order of the work and not its amount (N streams of 32 or 64
hold 5 * rank + 3 mod N as a bijection). Queries sit on frame
times: one at frame 0, and one every ``query_every`` frames after it when
that is not 0. Frame features
(``frame_num_tokens`` x ``vision_hidden_size``, fp16) come from a seeded
bank of ``bank_frames`` frames; video v of stream i reads the bank from a
seeded offset on.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from . import tokenizer as tk
from .weights import sub_seed


def feature_bank(seed: int, frames: int, tokens: int, width: int
                 ) -> np.ndarray:
    rng = np.random.default_rng(sub_seed(seed, 11))
    return rng.standard_normal((frames, tokens, width),
                               dtype=np.float32).astype(np.float16)


class ServePlan:
    """The videos each stream plays and where it enters the window."""

    def __init__(self, mix: Dict[str, Any], seed: int):
        self.mix, self.seed = mix, seed
        self.N = mix["streams"]
        rng = np.random.default_rng(sub_seed(seed, 10))
        self._len_rank = rng.permutation(self.N)
        # the entry rank is a fixed function of the first video's length
        # rank, so every seed has the same (length, entry) pairs
        self._enter_rank = (5 * self._len_rank + 3) % self.N

    def _frac(self, rank: int) -> float:
        return (rank + 0.5) / self.N

    def video(self, stream: int, index: int) -> Dict[str, Any]:
        """Video ``index`` of ``stream``: its length, bank offset and
        queries [(frame, text)]."""
        lo, hi = self.mix["video_frames"]
        rank = (int(self._len_rank[stream]) + 7 * index) % self.N
        length = int(round(lo + (hi - lo) * self._frac(rank)))
        rng = np.random.default_rng(sub_seed(self.seed, 1000003 * (stream + 1)
                                             + index))
        offset = int(rng.integers(self.mix["bank_frames"]))
        texts = self.mix["queries"]
        every = self.mix["query_every"] or length
        queries = [(f, texts[(stream + index + j) % len(texts)])
                   for j, f in enumerate(range(0, length, every))]
        return {"length": length, "offset": offset, "queries": queries}

    def entry(self, stream: int) -> int:
        """Frames of the first video that set-up ingests before the window."""
        lo, hi = self.mix["enter"]
        frac = lo + (hi - lo) * self._frac(int(self._enter_rank[stream]))
        return int(frac * self.video(stream, 0)["length"])


def video_features(bank: np.ndarray, video: Dict[str, Any], start: int = 0,
                   stop: int = None) -> np.ndarray:
    idx = (video["offset"] + np.arange(start, video["length"]
                                       if stop is None else stop)) % len(bank)
    return bank[idx]


def worst_dialogue_tokens(mix: Dict[str, Any], system_prompt: str,
                          frame_tokens: int) -> int:
    """KV slots the longest video's dialogue takes, its queries and the
    closing probe answered, at its last tick's admission (the engine
    reserves a chunk, a prompt bucket and a response budget past the
    offset)."""
    hi = mix["video_frames"][1]
    n_q = len(range(0, hi, mix["query_every"] or hi)) + mix["probe_rounds"]
    q_len = max(len(tk.encode(tk.query_text(q)))
                for q in mix["queries"] + [mix["probe_query"]])
    K = mix["chunk_frames"]
    budget = 4 + K * frame_tokens + (K - 1) + 128 + mix["max_new_tokens"]
    return (len(tk.encode(tk.start_text(system_prompt)))
            + hi * (frame_tokens + 1) + n_q * (q_len + mix["max_new_tokens"])
            + budget)

