"""LiveTrainer: the training driver.

Counterpart of ``videollm_online_tpu/train/trainer.py`` (which replaces HF
Trainer + DeepSpeed, reference train.py): host-side microbatch stacking for
gradient accumulation, the cosine LR, adapter checkpoints and metric
logging over the port's train step. The caller gives the dataset and the
collate function. Refused, with the ROADMAP item that brings each:
``evaluate`` (Queue 1 item 10, eval), a mesh or ``mesh_model_axis > 1`` and
the ``sp_ring``/``sp_ulysses`` attentions (item 13, parallel), and
``offload_optimizer`` and ``remat_group`` other than 1 (16 GiB-fit
mechanisms the port drops: it remats every layer on its own).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.arguments import LiveTrainingArguments
from ..core.config import LiveConfig
from ..data.loader import DataLoader
from ..utils.logging import MetricLogger
from . import checkpoints, optim
from . import step as step_mod


class LiveTrainer:
    def __init__(self, *, params: Dict[str, Any], cfg: LiveConfig,
                 tokenizer, args: LiveTrainingArguments,
                 train_dataset=None, collate_fn=None, mesh=None,
                 attn_impl=None):
        if mesh is not None or args.mesh_model_axis > 1:
            raise NotImplementedError(
                "meshes and mesh_model_axis > 1 come with the parallel slice "
                "(ROADMAP Queue 1 item 13)")
        if isinstance(attn_impl, str):
            raise NotImplementedError(
                f"attn_impl {attn_impl!r}: sequence-parallel attention comes "
                f"with the parallel slice (ROADMAP Queue 1 item 13)")
        for name, value in (("offload_optimizer", args.offload_optimizer),
                            ("remat_group", args.remat_group != 1)):
            if value:
                raise NotImplementedError(
                    f"{name} fits 8B into one 16 GiB chip; the port drops it "
                    f"(ROADMAP, dropped 16 GiB-fit mechanisms)")
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.args = args
        self.train_dataset = train_dataset
        self.collate_fn = collate_fn
        self.attn_impl = attn_impl
        self.logger = MetricLogger(args.output_dir)

        if train_dataset is not None:
            steps_per_epoch = max(
                len(train_dataset) // (args.per_device_train_batch_size
                                       * args.gradient_accumulation_steps), 1)
            self.total_steps = (args.max_steps or
                                int(steps_per_epoch * args.num_train_epochs))
        else:
            self.total_steps = max(args.max_steps, 1)
        self.optim_cfg = optim.OptimConfig(
            learning_rate=args.learning_rate, warmup_ratio=args.warmup_ratio,
            total_steps=self.total_steps)
        self.schedule = optim.make_schedule(self.optim_cfg)
        self.state, self.frozen = step_mod.init_train_state(params)
        self.device = optim.tree_leaves(self.state.trainable)[0].device

    def _step(self, state, frozen, batch):
        args = self.args
        return step_mod.train_step(
            state, frozen, batch, cfg=self.cfg, optim_cfg=self.optim_cfg,
            schedule=self.schedule,
            accum_steps=args.gradient_accumulation_steps,
            attn_impl=self.attn_impl, chunked_loss=args.chunked_loss,
            loss_chunk=args.loss_chunk or None)

    # ------------------------------------------------------------- training
    def _microbatch_stack(self, batches: List[dict]) -> dict:
        """Stack accum_steps collated microbatches along a leading axis,
        padding token dims to the max across the group."""
        accum = len(batches)
        T = max(b["input_ids"].shape[1] for b in batches)
        F = max((b["frames"].shape[0] if b["frames"] is not None else 0)
                for b in batches)
        B = batches[0]["input_ids"].shape[0]
        pad_id = self.tokenizer.pad_token_id
        ids = np.full((accum, B, T), pad_id, np.int32)
        labels = np.full((accum, B, T), -100, np.int32)
        fdim = next((b["frames"].shape[1:] for b in batches
                     if b["frames"] is not None), None)
        frames = (np.zeros((accum, max(F, 1)) + fdim, np.float32)
                  if fdim else None)
        for a, b in enumerate(batches):
            t = b["input_ids"].shape[1]
            ids[a, :, :t] = b["input_ids"]      # right padding stays right
            labels[a, :, :t] = b["labels"]
            if frames is not None and b["frames"] is not None:
                frames[a, :b["frames"].shape[0]] = b["frames"]
        out = {"input_ids": ids, "labels": labels}
        if frames is not None:
            out["frames"] = frames
        return out

    def train(self):
        args = self.args
        loader = DataLoader(
            self.train_dataset, batch_size=args.per_device_train_batch_size,
            collate_fn=self.collate_fn, shuffle=True, seed=args.seed,
            num_workers=args.dataloader_num_workers)
        accum = args.gradient_accumulation_steps
        micro: List[dict] = []
        t0 = time.time()
        done = False
        while not done:
            for batch in loader:
                micro.append(batch)
                if len(micro) < accum:
                    continue
                stacked = self._microbatch_stack(micro)
                micro = []
                if accum == 1:
                    stacked = {k: v[0] for k, v in stacked.items()}
                tbatch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    self.device) for k, v in stacked.items()}
                self.state, metrics = self._step(self.state, self.frozen,
                                                 tbatch)
                step = int(metrics["step"]) + 1
                if step % args.logging_steps == 0:
                    self.logger.log(step, {
                        "loss": float(metrics["loss"]),
                        "grad_norm": float(metrics["grad_norm"]),
                        "steps_per_sec": args.logging_steps / max(
                            time.time() - t0, 1e-9),
                    })
                    t0 = time.time()
                if (args.save_strategy == "steps" and args.save_steps
                        and step % args.save_steps == 0):
                    self.save_model(os.path.join(args.output_dir,
                                                 f"checkpoint-{step}"))
                if step >= self.total_steps:
                    done = True
                    break
            if args.save_strategy == "epoch" and not done:
                self.save_model(os.path.join(
                    args.output_dir, f"checkpoint-epoch{loader.epoch}"))
        return self.state

    def save_model(self, path: Optional[str] = None):
        path = path or self.args.output_dir
        checkpoints.save_adapter(os.path.join(path, "adapter"),
                                 self.state.trainable)

    @property
    def params(self) -> Dict[str, Any]:
        return optim.merge_params(self.state.trainable, self.frozen)

    def evaluate(self, *a, **kw):
        raise NotImplementedError(
            "evaluation needs eval/stream_evaluate.py and eval/generation.py, "
            "which come with the eval slice (ROADMAP Queue 1 item 10)")
