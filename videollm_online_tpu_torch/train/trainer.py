"""LiveTrainer: the training and evaluation driver.

Counterpart of ``videollm_online_tpu/train/trainer.py`` (which replaces HF
Trainer + TrainerWithGenToEval + DeepSpeed, reference train.py,
engine/trainer_with_gen2eval.py): host-side microbatch stacking for
gradient accumulation, the cosine LR, adapter checkpoints and metric
logging over the port's train step, and an eval loop that runs each
dataset's evaluator (stream_evaluate / generate / generate_after_embed) and
feeds the predictions to the dataset's ``compute_metrics``. The caller
gives the datasets and the collate function.

Parallel runs (every rank a process of an initialised
``torch.distributed`` world): ``mesh_model_axis > 1`` builds a (data,
model) mesh over the world, the params are cut by ``shard_params`` under
``sharding_policy``, each step's batch by ``shard_batch``, and the step
runs under the mesh; ``sp_ring`` / ``sp_ulysses`` bind the sequence-
parallel attention to the model axis, which then carries the sequence
(the base is cut over ``data`` only). The loader stripes by the rank's
DATA coordinate (the ranks of one data index must see the same samples);
``evaluate`` does too and runs tensor parallel over the model axis, or,
under a sequence-parallel attention, stripes by rank and runs each rank's
samples outside the mesh on the base it holds whole; it gathers the
predictions before ``compute_metrics``. Rank 0 alone logs and saves.

Memory: ``remat_group`` checkpoints groups of that many layers around the
per-layer checkpoints (``models/llama.py``), and ``offload_optimizer``
keeps the Adam moments in pinned host memory between steps
(``train/offload.py``), the analog of the reference's ZeRO-2 CPU offload.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.arguments import LiveTrainingArguments
from ..core.config import LiveConfig
from ..data.collator import collate
from ..data.loader import DataLoader
from ..eval.generation import beam_generate, greedy_from_embeds
from ..eval.stream_evaluate import StreamEvaluator
from ..parallel import collectives as coll
from ..parallel.context import ParallelContext
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh, maybe_mesh
from ..parallel.sharding import MATRICES
from ..utils.logging import MetricLogger
from . import checkpoints, optim
from . import step as step_mod


class LiveTrainer:
    def __init__(self, *, params: Dict[str, Any], cfg: LiveConfig,
                 tokenizer, args: LiveTrainingArguments,
                 train_dataset=None, eval_dataset_dict=None,
                 compute_metrics_dict=None, collate_fn=None, mesh=None,
                 attn_impl=None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.args = args
        self.train_dataset = train_dataset
        self.eval_dataset_dict = eval_dataset_dict or {}
        self.compute_metrics_dict = compute_metrics_dict or {}
        self.collate_fn = collate_fn
        device = optim.tree_leaves(params)[0].device
        self.mesh = mesh
        if self.mesh is None and args.mesh_model_axis > 1:
            self.mesh = make_mesh(data=-1, model=args.mesh_model_axis,
                                  device=device)
        if isinstance(attn_impl, str) and attn_impl.startswith("sp_"):
            # sequence-parallel attention over the model axis: 'sp_ring'
            # (ops/ring_attention.py) or 'sp_ulysses'
            # (ops/ulysses_attention.py)
            assert self.mesh is not None and \
                self.mesh.shape[MODEL_AXIS] > 1, (
                    f"attn_implementation={attn_impl!r} needs "
                    f"mesh_model_axis > 1")
            if attn_impl == "sp_ring":
                from ..ops.ring_attention import make_ring_attn
                attn_impl = make_ring_attn(self.mesh, MODEL_AXIS)
            else:
                from ..ops.ulysses_attention import make_ulysses_attn
                attn_impl = make_ulysses_attn(self.mesh, MODEL_AXIS)
        self.attn_impl = attn_impl
        self.is_main = not (dist.is_available() and dist.is_initialized()) \
            or dist.get_rank() == 0
        self.logger = MetricLogger(args.output_dir) if self.is_main else None

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
        if self.mesh is not None:
            # with a sequence-parallel attention the model axis carries
            # the sequence and the base stays whole along it (each rank
            # runs every weight on its T/N positions; a base cut along it
            # would be gathered a layer at a time, as fsdp gathers data)
            axes = ((DATA_AXIS,) if self._sequence_parallel()
                    else (DATA_AXIS, MODEL_AXIS))
            params = step_mod.shard_params(params, self.mesh,
                                           args.sharding_policy, cfg=cfg,
                                           axes=axes)
        self.state, self.frozen = step_mod.init_train_state(params)
        self.device = optim.tree_leaves(self.state.trainable)[0].device
        self._offload_step = None
        if args.offload_optimizer:
            from . import offload
            self.state = offload.offload_state(self.state)
            self._offload_step = offload.make_offload_train_step(
                cfg, self.optim_cfg, self.schedule,
                accum_steps=args.gradient_accumulation_steps,
                attn_impl=self.attn_impl, chunked_loss=args.chunked_loss,
                loss_chunk=args.loss_chunk or None,
                remat_group=args.remat_group)

    def _sequence_parallel(self) -> bool:
        return getattr(self.attn_impl, "sequence_axis", None) is not None

    def _stripes(self, evaluating: bool = False):
        """(index, count) of this rank's stripe of the samples: its data
        coordinate on a mesh, else its rank in the world. An evaluation
        under a sequence-parallel attention runs outside the mesh (decoding
        has no sequence to cut), so its stripes are the ranks."""
        if self.mesh is not None and not (evaluating and
                                          self._sequence_parallel()):
            return (self.mesh.coord(DATA_AXIS),
                    self.mesh.shape[DATA_AXIS])
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        return 0, 1

    def _log(self, step, metrics):
        if self.logger is not None:
            self.logger.log(step, metrics)

    def _step(self, state, frozen, batch):
        if self._offload_step is not None:
            return self._offload_step(state, frozen, batch)
        args = self.args
        return step_mod.train_step(
            state, frozen, batch, cfg=self.cfg, optim_cfg=self.optim_cfg,
            schedule=self.schedule,
            accum_steps=args.gradient_accumulation_steps,
            attn_impl=self.attn_impl, chunked_loss=args.chunked_loss,
            loss_chunk=args.loss_chunk or None,
            remat_group=args.remat_group)

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
        index, count = self._stripes()
        loader = DataLoader(
            self.train_dataset, batch_size=args.per_device_train_batch_size,
            collate_fn=self.collate_fn, shuffle=True, seed=args.seed,
            num_workers=args.dataloader_num_workers, process_index=index,
            process_count=count)
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
                if self.mesh is not None:
                    tbatch = step_mod.shard_batch(
                        tbatch, self.mesh, accum_axis=accum > 1,
                        cfg=self.cfg)
                with maybe_mesh(self.mesh):
                    self.state, metrics = self._step(self.state,
                                                     self.frozen, tbatch)
                step = int(metrics["step"]) + 1
                if step % args.logging_steps == 0:
                    self._log(step, {
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
        if not self.is_main:   # the trainable tree is the same on every rank
            return
        path = path or self.args.output_dir
        checkpoints.save_adapter(os.path.join(path, "adapter"),
                                 self.state.trainable)

    @property
    def params(self) -> Dict[str, Any]:
        return optim.merge_params(self.state.trainable, self.frozen)

    # ------------------------------------------------------------ evaluation
    def _eval_params(self) -> Dict[str, Any]:
        """The params with their data-axis shards gathered: ranks of other
        data indices evaluate other samples, so only the model axis may
        carry collectives in the forward (and none outside the mesh)."""
        params = self.params
        if self.mesh is None or self.mesh.shape[DATA_AXIS] == 1:
            return params
        par = ParallelContext(self.mesh, self.cfg.llama,
                              sequence_parallel=self._sequence_parallel())
        lp = params["llama"]
        llama_p = dict(lp, layers={
            n: (par.weight(m, n) if n in MATRICES else m)
            for n, m in lp["layers"].items()})
        for name in ("embed", "lm_head"):
            if name in lp:
                llama_p[name] = par.weight(lp[name], name)
        return dict(params, llama=llama_p)

    def evaluate(self, dataset_name: Optional[str] = None, *,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None) -> Dict[str, dict]:
        """Run each eval dataset through its evaluator and compute metrics
        (reference trainer_with_gen2eval.py + train.py:27-36).

        Samples ``process_index::process_count`` are evaluated, by default
        this rank's stripe (``_stripes``); with the default stripes of a
        run of several, every rank's predictions and sample indices are
        gathered (``all_gather_object``, the HF eval-loop gather of
        trainer_with_gen2eval.py:20-21) into the single-process order
        before ``compute_metrics``, which rank 0 runs and hands to all.
        On a mesh the evaluators run tensor parallel over the model axis;
        under a sequence-parallel attention, outside the mesh."""
        own_index, own_count = self._stripes(evaluating=True)
        mesh = None if self._sequence_parallel() else self.mesh
        gather = process_index is None and process_count is None \
            and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1
        if process_index is None:
            process_index = own_index
        if process_count is None:
            process_count = own_count
        results = {}
        names = ([dataset_name] if dataset_name
                 else list(self.eval_dataset_dict))
        params = self._eval_params()
        for name in names:
            ds = self.eval_dataset_dict[name]
            predictions, sample_idxs, order = [], [], []
            evaluators = {}
            with maybe_mesh(mesh):
                for i in range(process_index, len(ds), process_count):
                    pred, idx = self._predict(params, ds[i], evaluators)
                    predictions.append(pred)
                    sample_idxs.append(idx)
                    order.append(i)
            if gather:
                rows = [r for part in coll.all_gather_object(
                    list(zip(order, predictions, sample_idxs)))
                    for r in part]
                rows = sorted(dict((o, (p, x)) for o, p, x in rows).items())
                predictions = [p for _, (p, _) in rows]
                sample_idxs = [x for _, (_, x) in rows]
            # pad rows to a rectangle as the HF gather does
            L = max((len(p) for p in predictions), default=1)
            rect = np.full((len(predictions), L), -100.0
                           if predictions and predictions[0].dtype.kind == "f"
                           else -100)
            for i, p in enumerate(predictions):
                rect[i, :len(p)] = p
            fn = self.compute_metrics_dict.get(name)
            if fn is None and hasattr(ds, "compute_metrics"):
                fn = lambda preds, idxs: ds.compute_metrics(  # noqa: E731
                    preds, idxs, tokenizer=self.tokenizer,
                    output_dir=self.args.output_dir)
            metrics = None
            if self.is_main or not gather:
                metrics = fn(rect, np.asarray(sample_idxs)) if fn else {}
            if gather:
                metrics = coll.all_gather_object(metrics)[0]
            results[name] = metrics
            if self.logger is not None:
                self.logger.log_dict(f"eval/{name}", results[name])
        return results

    def _predict(self, params, item, evaluators):
        """(prediction, sample index) of one sample through its evaluator;
        ``evaluators`` keeps the dataset's StreamEvaluator, made at its
        first use."""
        text, frames, learn_ranges, idx, ekw = item
        # right padding to a bucket never enters attention
        batch = collate([(text, frames, learn_ranges, idx, ekw)],
                        tokenizer=self.tokenizer,
                        pad_to_multiple=max(self.args.pad_to_multiple, 1))
        num_valid = int(batch["attention_mask"][0].sum())
        ekw = ekw or {}
        evaluator = ekw.get("evaluator", "stream_evaluate")
        if evaluator == "stream_evaluate":
            if "stream" not in evaluators:
                evaluators["stream"] = StreamEvaluator(params, self.cfg)
            pred = evaluators["stream"](
                batch["input_ids"], batch["labels"], batch["frames"],
                self.args.frame_token_interval_threshold)
        elif evaluator == "generate":
            pred = beam_generate(
                params, self.cfg, batch["input_ids"], batch["frames"],
                num_beams=ekw.get("num_beams", 1),
                max_new_tokens=ekw.get("max_new_tokens", 512),
                num_return_sequences=ekw.get("num_return_sequences"),
                num_valid=num_valid,
            ).reshape(-1)
        elif evaluator == "generate_after_embed":
            pred = greedy_from_embeds(
                params, self.cfg, batch["input_ids"], batch["frames"],
                max_new_tokens=ekw.get("max_new_tokens", 512),
                num_valid=num_valid,
            ).reshape(-1)
        else:
            raise ValueError(f"unknown evaluator {evaluator}")
        return np.asarray(pred), idx
