"""Evaluation entry point (reference evaluate.py:7-33): the training entry
point without the train loop; the adapter comes from
``--resume_from_checkpoint``.

Counterpart of ``videollm_online_tpu/evaluate_entry.py``:

  python -m videollm_online_tpu_torch.evaluate_entry --live_version live1+ \\
      --eval_datasets coin_step_test --resume_from_checkpoint outputs/run1 \\
      [--device cpu]

Runs on the card unless ``--device cpu`` asks for the CPU. Prints the
metrics and writes ``<output_dir>/eval_results.json``.
"""

from __future__ import annotations

import argparse
import json
import os

from .core.arguments import parse_args
from .data.collator import make_collator
from .data.registry import build_eval_dataset_dict
from .models.builder import build_model_and_tokenizer
from .train.trainer import LiveTrainer


def split_device(argv=None):
    """(device or None, the other arguments): ``--device`` is the port's
    own argument, beside the JAX package's training arguments."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="")
    known, rest = pre.parse_known_args(argv)
    return known.device or None, rest


def data_kwargs(args, tokenizer, augmentation: bool):
    return dict(
        tokenizer=tokenizer, system_prompt=args.system_prompt,
        augmentation=augmentation, max_num_frames=args.max_num_frames,
        vision_pretrained=args.vision_pretrained, embed_mark=args.embed_mark,
        frame_fps=args.frame_fps)


def write_results(metrics, output_dir: str) -> None:
    print(json.dumps(metrics, indent=1))
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "eval_results.json"), "w") as f:
        json.dump(metrics, f, indent=1)


def evaluate(argv=None):
    device, argv = split_device(argv)
    args = parse_args(argv)
    params, tokenizer, cfg = build_model_and_tokenizer(
        args, is_training=False, device=device)
    eval_dict = build_eval_dataset_dict(
        args.eval_datasets, **data_kwargs(args, tokenizer, False))
    trainer = LiveTrainer(
        params=params, cfg=cfg, tokenizer=tokenizer, args=args,
        eval_dataset_dict=eval_dict, collate_fn=make_collator(tokenizer))
    metrics = trainer.evaluate()
    write_results(metrics, args.output_dir)
    return metrics


if __name__ == "__main__":
    evaluate()
