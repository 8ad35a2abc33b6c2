"""Batch collation: text -> (input_ids, labels) with char-range supervision.

A copy of ``videollm_online_tpu/data/collator.py`` (reference
data/data_collator.py:6-33):
  * tokenize the rendered conversations with offset mappings;
  * labels start at -100; for each learn char-range, the token *preceding*
    the range start is supervised with the tokens inside the range
    (shift-by-1: ``labels[start-1:stop-1] = input_ids[start:stop]``);
  * labels >= v_placeholder_id are remapped to EOS (the "streaming EOS"
    objective of live1, data_collator.py:23);
  * frame features are concatenated across the batch in sample order
    (``joint_embed`` consumes them in flattened ``<v>`` order).

``pad_to_multiple`` buckets sequence lengths; with the default 256 of
``LiveTrainingArguments`` every training length is a multiple of 128, which
is what sends the attention to the flash kernel (ops/auto.py).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np

from ..tokenizer.live_tokenizer import LiveTokenizer

IGNORE_INDEX = -100


def collate(
    batch: Sequence[Any],
    *,
    tokenizer: LiveTokenizer,
    pad_to_multiple: int = 1,
) -> Dict[str, Any]:
    """``batch``: list of (text, frames, learn_ranges, sample_idx,
    evaluation_kwargs) tuples. Returns numpy arrays."""
    texts, frames_list, learn_ranges_list, sample_idxs, eval_kwargs = zip(*batch)
    enc = tokenizer.batch_encode(list(texts), pad_to_multiple=pad_to_multiple)
    input_ids = enc["input_ids"]
    offsets = enc["offset_mapping"]
    labels = np.full_like(input_ids, IGNORE_INDEX)
    v_id = tokenizer.cfg.v_placeholder_id
    eos_id = tokenizer.cfg.eos_token_id

    for i, learn_ranges in enumerate(learn_ranges_list):
        starts = offsets[i, :, 0]
        valid = enc["attention_mask"][i].astype(bool)
        for r in learn_ranges:
            cand = np.nonzero((starts == r.start) & valid)[0]
            if cand.size != 1:
                raise ValueError(
                    f"learn range start {r.start} must align with exactly "
                    f"one token boundary, got {cand.size}")
            start = int(cand[0])
            if starts[valid][-1] >= r.stop:
                cand_stop = np.nonzero((starts == r.stop) & valid)[0]
                if cand_stop.size != 1:
                    raise ValueError(
                        f"learn range stop {r.stop} must align with exactly "
                        f"one token boundary, got {cand_stop.size}")
                stop = int(cand_stop[0])
            else:  # the range runs to the final eos token
                # right padding: the real token count is the stop, so eos
                # (== pad) targets never spill into the padding
                stop = int(valid.sum())
            labels[i, start - 1:stop - 1] = input_ids[i, start:stop]
    labels[labels >= v_id] = eos_id

    out: Dict[str, Any] = {
        "input_ids": input_ids,
        "attention_mask": enc["attention_mask"],
        "labels": labels,
        "sample_idxs": np.asarray(sample_idxs),
    }
    frames = [np.asarray(f) for f in frames_list if f is not None and np.size(f)]
    out["frames"] = np.concatenate(frames, axis=0) if frames else None
    if eval_kwargs[0]:
        out["evaluation_kwargs"] = eval_kwargs[0]
    return out


def make_collator(tokenizer: LiveTokenizer, pad_to_multiple: int = 1):
    def fn(batch):
        return collate(batch, tokenizer=tokenizer,
                       pad_to_multiple=pad_to_multiple)
    return fn
