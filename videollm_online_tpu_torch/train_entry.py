"""Training entry point (reference train.py:7-40).

Counterpart of ``videollm_online_tpu/train_entry.py``:

  python -m videollm_online_tpu_torch.train_entry --live_version live1+ \\
      --train_datasets coin_step_train --eval_datasets coin_step_test \\
      --model_size tiny --max_steps 20 --output_dir outputs/run1 \\
      [--device cpu]

Builds the model and tokenizer, the train and eval datasets, trains, saves
the adapter, then evaluates each eval dataset with its evaluator. Runs on
the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

from .core.arguments import parse_args
from .data.collator import make_collator
from .data.registry import build_concat_train_dataset, build_eval_dataset_dict
from .evaluate_entry import data_kwargs, split_device, write_results
from .models.builder import build_model_and_tokenizer
from .ops.auto import resolve_attn_impl
from .train.trainer import LiveTrainer


def train(argv=None):
    device, argv = split_device(argv)
    args = parse_args(argv)
    params, tokenizer, cfg = build_model_and_tokenizer(
        args, is_training=True, device=device)
    train_dataset = build_concat_train_dataset(
        args.train_datasets, **data_kwargs(args, tokenizer,
                                           args.augmentation))
    eval_dict = build_eval_dataset_dict(
        args.eval_datasets, **data_kwargs(args, tokenizer, False))
    trainer = LiveTrainer(
        params=params, cfg=cfg, tokenizer=tokenizer, args=args,
        train_dataset=train_dataset, eval_dataset_dict=eval_dict,
        collate_fn=make_collator(tokenizer,
                                 pad_to_multiple=args.pad_to_multiple),
        attn_impl=resolve_attn_impl(args.attn_implementation))
    if train_dataset is not None:
        trainer.train()
        trainer.save_model()
    if eval_dict:
        write_results(trainer.evaluate(), args.output_dir)
    return trainer


if __name__ == "__main__":
    train()
