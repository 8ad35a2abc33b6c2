"""Offline stage 3: LLM-based narration refinement (reference
data/preprocess/ego4d_narration_refinement.py): rewrite raw Ego4D narrations
('[C looks around.]' -> '[You look around.]') with a few-shot-prompted Llama.

The generation backend is pluggable: our own Llama + greedy decode when
converted weights are given, or any callable ``generate_fn(prompt) -> str``.
Outputs one refined JSON per video, skipping existing files (idempotent
resume, like the reference :33).

Counterpart of ``videollm_online_tpu/data/preprocess/
narration_refinement_job.py``: the prompt, ``refine_text`` and ``run`` are
copies; ``make_llama_generate_fn`` decodes on the port's builder and
``eval/generation.py::greedy_from_embeds``, on the card unless ``--device
cpu`` asks for the CPU."""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict

from .sharding import shard

REFINE_PROMPT = (
    "Please help me to refine the text, e.g., [C looks around.] -> "
    "[You look around.]In the text, There are many uppercase letters to "
    "denote persons. Rewrite the sentence to avoid these uppercase letters, "
    "improve the text quality, make the text clear and concise. "
    "For example:\n[C looks around.] -> [You look around.]\n"
    "[A man X watches the phone.] -> [A man watches the phone.]\n"
    "[C plays a piano, and a woman O comes to him.] -> "
    "[You play a piano, and a woman comes to you.]\n"
    "[Man A approaches C] -> [A man approaches you.]\n\n"
    "Now, please refine [{text}] -> ?, make the answer in []."
)
FALLBACK = "Not sure what you are doing."


def refine_text(raw: str, generate_fn: Callable[[str], str],
                cache: Dict[str, str]) -> str:
    if raw in cache:
        return cache[raw]
    out = generate_fn(REFINE_PROMPT.format(text=raw))
    try:
        refined = out[: out.index("]")]
    except ValueError:
        refined = FALLBACK
    cache[raw] = refined
    return refined


def run(anno_root: str, split: str, generate_fn: Callable[[str], str]):
    anno_path = os.path.join(anno_root, f"narration_stream_{split}.json")
    save_dir = os.path.join(anno_root, f"refined_narration_stream_{split}")
    os.makedirs(save_dir, exist_ok=True)
    with open(anno_path) as f:
        annos = json.load(f)
    pending = {uid: v for uid, v in annos.items()
               if not os.path.exists(os.path.join(save_dir, f"{uid}.json"))}
    cache: Dict[str, str] = {}
    for _, uid in shard(sorted(pending)):
        streams = pending[uid]
        for narrations in streams.values():
            for n in narrations:
                n["text"] = refine_text(n["text"], generate_fn, cache)
        with open(os.path.join(save_dir, f"{uid}.json"), "w") as f:
            json.dump(streams, f, indent=4)
    print(f"refined {len(pending)} videos -> {save_dir}")


def make_llama_generate_fn(weights: str, tokenizer_path: str,
                           max_new_tokens: int = 64, *, device=None):
    """Greedy refinement decoder on our own stack (the reference uses HF
    generate with max 64 tokens, refinement:25). Every decode step attends
    through ``ops.auto.auto_attention``: the ring decode kernel K1 on the
    card."""
    import numpy as np
    from ...core.arguments import LiveOnePlusTrainingArguments
    from ...eval.generation import greedy_from_embeds
    from ...models.builder import build_model_and_tokenizer

    args = LiveOnePlusTrainingArguments(
        llm_weights=weights, tokenizer_path=tokenizer_path, lora_r=0)
    params, tok, cfg = build_model_and_tokenizer(args, is_training=False,
                                                 device=device)

    def generate_fn(prompt: str) -> str:
        # few-shot chat with a forced assistant prefix '[' continuation
        text = tok.apply_chat_template(
            [{"role": "user", "content": prompt}], add_generation_prompt=True)
        text += " ["
        ids = np.asarray([tok.encode(text)])
        out = greedy_from_embeds(params, cfg, ids, None,
                                 max_new_tokens=max_new_tokens)
        return tok.decode(out[0], skip_special_tokens=True)

    return generate_fn


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--anno_root", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--llm_weights", default="")
    p.add_argument("--tokenizer_path", default="")
    p.add_argument("--device", default="",
                   help="'cpu' for the CPU; the card otherwise")
    a = p.parse_args(argv)
    fn = make_llama_generate_fn(a.llm_weights, a.tokenizer_path,
                                device=a.device or None)
    run(a.anno_root, a.split, fn)


if __name__ == "__main__":
    main()
