"""How one decoder forward runs on the current mesh.

The JAX package runs the same ``llama.forward`` on any mesh and GSPMD
derives the collectives from the argument shardings. Here the forward asks
``ParallelContext.current`` once, and the answer names what each layer
does with the rank-local tree that ``train.step.shard_params`` built:

  * tensor parallel (the model axis cuts heads, the MLP and the
    vocabulary): column-parallel q/k/v/gate/up on the local columns, the
    row-parallel o/down partial sums all-reduced over ``model``, the local
    ``Hq/N`` query heads and ``Hkv/N`` kv heads (or the one kv head a
    rank's query heads read, when N > Hkv); LoRA and attention biases are
    replicated and each rank applies the slice of them that matches its
    columns or rows;
  * sequence parallel (a ring or Ulysses attention whose
    ``sequence_axis`` is ``model``): the model axis carries the sequence
    and the weights are whole along it (``shard_params(...,
    axes=("data",))``), so the token-local matmuls run on whole matrices;
    a tree cut along the model axis is refused;
  * ``fsdp_tp``: the weights' data-axis shards are all-gathered once a
    layer (in the forward and again in a remat recompute; the base is
    frozen, so nothing is reduce-scattered for it).

A data-axis shard is recognised by its shape: a dim shorter than the
logical one (``cfg``) is gathered.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import collectives as coll
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, current_mesh
from .sharding import (ROW_PARALLEL, leaf_parts, logical_shape,
                       merge_matrix, model_range_key, tp_ranges, with_parts)


class ParallelContext:
    def __init__(self, mesh: Mesh, cfg, *, sequence_parallel: bool = False):
        self.mesh = mesh
        self.cfg = cfg
        self.sp = sequence_parallel
        self.tp = 1 if sequence_parallel else mesh.shape[MODEL_AXIS]
        self.ranges = (tp_ranges(cfg, self.tp, mesh.coord(MODEL_AXIS))
                       if self.tp > 1 else None)
        D, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
        self.full = {"wq": (D, cfg.q_dim), "wk": (D, cfg.kv_dim),
                     "wv": (D, cfg.kv_dim), "wo": (cfg.q_dim, D),
                     "w_gate": (D, F), "w_up": (D, F), "w_down": (F, D),
                     "embed": (V, D), "lm_head": (D, V)}

    @classmethod
    def current(cls, cfg, attn_impl=None) -> Optional["ParallelContext"]:
        mesh = current_mesh()
        if mesh is None or mesh.size == 1:
            return None
        sp = getattr(attn_impl, "sequence_axis", None) == MODEL_AXIS
        return cls(mesh, cfg, sequence_parallel=sp)

    # ------------------------------------------------------ local counts
    def heads(self) -> Tuple[int, int]:
        """(query heads, kv heads) this rank's attention runs."""
        hd = self.cfg.head_dim
        if self.ranges is None:
            return self.cfg.num_heads, self.cfg.num_kv_heads
        return self.ranges["q"][1] // hd, self.ranges["kv"][1] // hd

    def col_range(self, name: str) -> Optional[Tuple[int, int]]:
        """The model-axis range of ``name``'s tensor-parallel dim."""
        if self.ranges is None:
            return None
        return self.ranges[model_range_key(name)]

    def check_sharded(self, wq) -> None:
        cols = logical_shape(wq)[-1]
        if self.sp and cols != self.cfg.q_dim:
            raise ValueError(
                "sequence parallel over model="
                f"{self.mesh.shape[MODEL_AXIS]} runs weights whole along "
                "the model axis (train.step.shard_params(..., "
                "axes=('data',))); got a tree cut along it")
        if self.ranges is not None and cols != self.ranges["q"][1]:
            raise ValueError(
                "tensor parallel over model="
                f"{self.tp} needs the rank-local tree of "
                "train.step.shard_params; got whole query columns")

    # ---------------------------------------------------------- weights
    def weight(self, leaf, name: str):
        """``leaf`` (one layer's, or the embedding or head) with its
        data-axis shards all-gathered."""
        n = self.mesh.shape[DATA_AXIS]
        # fsdp_tp cuts a row-parallel matrix's output dim over data, every
        # other matrix's first dim
        dim = 1 if name in ROW_PARALLEL else 0
        if n == 1 or logical_shape(leaf)[dim - 2] >= self.full[name][dim]:
            return leaf
        per_tensor = [coll.all_gather_list(t, self.mesh, DATA_AXIS)
                      for t in leaf_parts(leaf)]
        parts = [with_parts(leaf, [p[r] for p in per_tensor])
                 for r in range(n)]
        return merge_matrix(parts, dim - 2, row_scaled=name == "embed")

    def lora(self, pair, name: str):
        """The slice of a replicated LoRA pair (``lora_a`` (r, in),
        ``lora_b`` (out, r)) that matches this rank's columns or rows."""
        if pair is None or self.ranges is None:
            return pair
        s, c = self.col_range(name)
        if name in ROW_PARALLEL:
            return {"lora_a": pair["lora_a"].narrow(-1, s, c),
                    "lora_b": pair["lora_b"]}
        return {"lora_a": pair["lora_a"],
                "lora_b": pair["lora_b"].narrow(-2, s, c)}

    def bias(self, b: torch.Tensor, name: str) -> torch.Tensor:
        if self.ranges is None:
            return b
        s, c = self.col_range(name)
        return b.narrow(-1, s, c)

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        """Sum a row-parallel partial product over the model axis."""
        if self.tp == 1:
            return y
        return coll.all_reduce(y, self.mesh, MODEL_AXIS)


def local_kv_heads(cfg) -> int:
    """The kv heads a KV cache made under the current mesh holds."""
    ctx = ParallelContext.current(cfg)
    return cfg.num_kv_heads if ctx is None else ctx.heads()[1]
