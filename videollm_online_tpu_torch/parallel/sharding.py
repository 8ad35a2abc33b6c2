"""Parameter and activation partition rules, and the rank-local shards.

Counterpart of ``videollm_online_tpu/parallel/sharding.py``. ``param_specs``
gives the JAX package's spec for every leaf, by path, as a tuple of
``"data"``, ``"model"`` or None per dim (a ``PartitionSpec``'s entries):

  * ``tp``      -- Megatron tensor parallel over ``model`` (column-parallel
                   q/k/v/gate/up, row-parallel o/down, the embedding on D,
                   the head on the vocabulary);
  * ``fsdp_tp`` -- additionally the other dim of every large matrix over
                   ``data`` (the ZeRO-3 analogue).

GSPMD shards a global array and moves data to keep the function right;
here a rank holds a self-contained local matrix, so ``shard_matrix`` cuts
the LOGICAL matrix and rebuilds its layout:

  * int8 ``{"q8": (in, out), "scale": (out,)}``: the codes are cut, the
    scale only where ``out`` is (a row-parallel matrix keeps it whole; the
    embedding's per-row scale follows its rows);
  * ``q4c`` (byte (k, j) pairs columns j and j + out/2) cut along ``out``
    is unpacked and repacked to the local pairing; ``q4p`` (byte (i, j)
    pairs rows i and i + in/2) likewise along ``in``;
  * an int4 scale group may not straddle two shards (``ValueError``).

The model-axis ranges follow heads: q/o by query heads; k/v by the kv
heads the rank's query heads read, so that a model axis wider than the kv
heads keeps whole kv heads on every rank (Megatron's kv replication;
``tp_ranges``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .mesh import DATA_AXIS, MODEL_AXIS

Spec = Tuple[Optional[str], ...]

# (path-substring, policy) -> spec; the JAX package's table. Paths are
# '/'-joined key paths; layer-stacked leaves carry a leading layer dim.
_RULES = [
    # LoRA overlays FIRST (their paths contain the base-weight names)
    ("lora_a",      {"tp": (),                     "fsdp_tp": ()}),
    ("lora_b",      {"tp": (),                     "fsdp_tp": ()}),
    # decoder
    ("embed",       {"tp": (None, MODEL_AXIS),       "fsdp_tp": (DATA_AXIS, MODEL_AXIS)}),
    ("wq",          {"tp": (None, None, MODEL_AXIS), "fsdp_tp": (None, DATA_AXIS, MODEL_AXIS)}),
    ("wk",          {"tp": (None, None, MODEL_AXIS), "fsdp_tp": (None, DATA_AXIS, MODEL_AXIS)}),
    ("wv",          {"tp": (None, None, MODEL_AXIS), "fsdp_tp": (None, DATA_AXIS, MODEL_AXIS)}),
    ("wo",          {"tp": (None, MODEL_AXIS, None), "fsdp_tp": (None, MODEL_AXIS, DATA_AXIS)}),
    ("w_gate",      {"tp": (None, None, MODEL_AXIS), "fsdp_tp": (None, DATA_AXIS, MODEL_AXIS)}),
    ("w_up",        {"tp": (None, None, MODEL_AXIS), "fsdp_tp": (None, DATA_AXIS, MODEL_AXIS)}),
    ("w_down",      {"tp": (None, MODEL_AXIS, None), "fsdp_tp": (None, MODEL_AXIS, DATA_AXIS)}),
    ("lm_head",     {"tp": (None, MODEL_AXIS),       "fsdp_tp": (DATA_AXIS, MODEL_AXIS)}),
    ("vision",      {"tp": (),                     "fsdp_tp": ()}),
    ("connector",   {"tp": (),                     "fsdp_tp": ()}),
]

POLICIES = ("tp", "fsdp_tp")
COLUMN_PARALLEL = ("wq", "wk", "wv", "w_gate", "w_up")
ROW_PARALLEL = ("wo", "w_down")
MATRICES = COLUMN_PARALLEL + ROW_PARALLEL


def _spec_for_path(path: str, policy: str, ndim: int) -> Spec:
    for needle, by_policy in _RULES:
        if needle in path:
            spec = by_policy[policy]
            if len(spec) == 0:  # replicated: valid for any rank
                return spec
            # the unstacked variant of a layer-stacked rule
            if len(spec) > ndim:
                spec = spec[len(spec) - ndim:]
            if len(spec) < ndim:
                spec = (None,) * (ndim - len(spec)) + tuple(spec)
            return tuple(spec)
    return ()  # norms, biases, everything small: replicated


def param_specs(params: Any, policy: str = "tp") -> Any:
    """The spec tree matching ``params`` under ``policy``, leaf for leaf
    (a quantized matrix's codes and scale each get their path's spec, as
    in the JAX package)."""
    assert policy in POLICIES, policy

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        return _spec_for_path("/".join(path), policy, node.ndim)

    return walk(params, ())


def batch_spec() -> Spec:
    """Activations: batch over the data axis."""
    return (DATA_AXIS,)


def kv_cache_spec() -> Spec:
    """KV cache (layers, batch, kv_heads, max_len, head_dim): heads over
    the model axis."""
    return (None, DATA_AXIS, MODEL_AXIS, None, None)


# ------------------------------------------------------ model-axis ranges
def tp_ranges(cfg, n: int, i: int) -> Dict[str, Tuple[int, int]]:
    """Rank ``i`` of a model axis of ``n``: (start, count) in units of the
    logical dim for the query heads' columns ``q``, the kv heads' ``kv``,
    the MLP's ``f``, the vocabulary ``v`` and the hidden ``d``. A model
    axis wider than the kv heads gives each rank the one kv head its query
    heads read."""
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if Hq % n:
        raise ValueError(f"{Hq} query heads do not split over model={n}")
    if Hkv % n == 0:
        kv = (i * (Hkv // n), Hkv // n)
    elif n % Hkv == 0:
        kv = (i * Hkv // n, 1)
    else:
        raise ValueError(f"{Hkv} kv heads and model={n}: neither divides "
                         f"the other")
    for name, dim in (("intermediate", cfg.intermediate_size),
                      ("vocab", cfg.vocab_size), ("hidden", cfg.hidden_size)):
        if dim % n:
            raise ValueError(f"{name} size {dim} does not split over "
                             f"model={n}")
    qh = Hq // n
    return {"q": (i * qh * hd, qh * hd), "kv": (kv[0] * hd, kv[1] * hd),
            "f": (i * (cfg.intermediate_size // n), cfg.intermediate_size // n),
            "v": (i * (cfg.vocab_size // n), cfg.vocab_size // n),
            "d": (i * (cfg.hidden_size // n), cfg.hidden_size // n)}


def model_range_key(name: str) -> str:
    """Which ``tp_ranges`` entry cuts matrix ``name`` over the model
    axis."""
    if name in ("wk", "wv"):
        return "kv"
    if name in ("wq", "wo"):
        return "q"
    if name in ("w_gate", "w_up", "w_down"):
        return "f"
    if name == "embed":
        return "d"
    if name == "lm_head":
        return "v"
    raise KeyError(name)


# ------------------------------------------------------- layouts, cutting
def _layout(leaf) -> str:
    if not isinstance(leaf, dict):
        return "plain"
    for key in ("q8", "q4c", "q4p"):
        if key in leaf:
            return key
    raise ValueError(f"unknown quantized layout {sorted(leaf)}")


def logical_shape(leaf) -> Tuple[int, ...]:
    """The shape of the matrix a plain or quantized leaf stands for."""
    kind = _layout(leaf)
    if kind == "plain":
        return tuple(leaf.shape)
    codes = leaf[kind]
    if kind == "q4c":
        return tuple(codes.shape[:-1]) + (2 * codes.shape[-1],)
    if kind == "q4p":
        return tuple(codes.shape[:-2]) + (2 * codes.shape[-2],
                                          codes.shape[-1])
    return tuple(codes.shape)


def _q4c_values(p: torch.Tensor) -> torch.Tensor:
    """Packed q4c bytes (.., in, out/2) -> nibble values (.., in, out)."""
    v = p.to(torch.int32)
    return torch.cat([(v & 0x0F) - 8, v >> 4], dim=-1)


def _q4c_pack(q: torch.Tensor) -> torch.Tensor:
    half = q.shape[-1] // 2
    return (16 * q[..., half:] + (q[..., :half] + 8)).to(torch.int8)


def _q4p_values(p: torch.Tensor) -> torch.Tensor:
    """Packed q4p bytes (.., in/2, out) -> nibble values (.., in, out)."""
    v = p.to(torch.int32)
    return torch.cat([((v & 0x0F) ^ 8) - 8, v >> 4], dim=-2)


def _q4p_pack(q: torch.Tensor) -> torch.Tensor:
    half = q.shape[-2] // 2
    lo, hi = q[..., :half, :], q[..., half:, :]
    v = (lo & 0x0F) | (hi << 4)
    return (((v & 0xFF) ^ 0x80) - 0x80).to(torch.int8)


def _int4_group(leaf, kind: str) -> int:
    d_in = logical_shape(leaf)[-2]
    return d_in // leaf["scale"].shape[-2]


def shard_matrix(leaf, dim: int, start: int, count: int,
                 row_scaled: bool = False):
    """Cut ``leaf`` (plain, q8, q4c or q4p) to logical rows or columns
    [start, start + count) of ``dim``, rebuilding the layout.
    ``row_scaled``: an int8 matrix whose scale runs along dim 0 (the
    embedding table) instead of the last dim."""
    kind = _layout(leaf)
    nd = len(logical_shape(leaf))
    dim %= nd
    if kind == "plain":
        return leaf.narrow(dim, start, count).contiguous()
    codes, scale = leaf[kind], leaf["scale"]
    if kind == "q8":
        out = {"q8": codes.narrow(dim, start, count).contiguous()}
        if row_scaled:
            s_dim = dim if dim < nd - 1 else None
        else:
            s_dim = (nd - 2 if dim == nd - 1 else dim if dim < nd - 2
                     else None)
        out["scale"] = (scale if s_dim is None
                        else scale.narrow(s_dim, start, count).contiguous())
        return out
    group = _int4_group(leaf, kind)
    if dim == nd - 2:   # the reduction dim: whole scale groups only
        if start % group or count % group:
            raise ValueError(
                f"int4 scale groups of {group} would straddle a shard of "
                f"rows [{start}, {start + count})")
        s = scale.narrow(nd - 2, start // group, count // group)
    else:
        s = scale.narrow(dim, start, count)
    if kind == "q4c":
        if dim == nd - 1:
            if count % 2:
                raise ValueError(f"a q4c shard needs an even column count, "
                                 f"got {count}")
            c = _q4c_pack(_q4c_values(codes).narrow(dim, start, count))
        else:
            c = codes.narrow(dim, start, count)
    else:
        if dim == nd - 2:
            if count % 2:
                raise ValueError(f"a q4p shard needs an even row count, "
                                 f"got {count}")
            c = _q4p_pack(_q4p_values(codes).narrow(dim, start, count))
        else:
            c = codes.narrow(dim, start, count)
    return {kind: c.contiguous(), "scale": s.contiguous()}


def merge_matrix(parts: Sequence, dim: int, row_scaled: bool = False):
    """The inverse of ``shard_matrix``: the pieces of consecutive ranges
    of ``dim``, joined into one leaf of the same layout."""
    kind = _layout(parts[0])
    nd = len(logical_shape(parts[0]))
    dim %= nd
    if kind == "plain":
        return torch.cat(list(parts), dim=dim)
    codes = [p[kind] for p in parts]
    scales = [p["scale"] for p in parts]
    if kind == "q8":
        if row_scaled:
            s_dim = dim if dim < nd - 1 else None
        else:
            s_dim = (nd - 2 if dim == nd - 1 else dim if dim < nd - 2
                     else None)
        return {"q8": torch.cat(codes, dim=dim),
                "scale": (scales[0] if s_dim is None
                          else torch.cat(scales, dim=s_dim))}
    s = torch.cat(scales, dim=dim)
    if kind == "q4c" and dim == nd - 1:
        c = _q4c_pack(torch.cat([_q4c_values(x) for x in codes], dim=dim))
    elif kind == "q4p" and dim == nd - 2:
        c = _q4p_pack(torch.cat([_q4p_values(x) for x in codes], dim=dim))
    else:
        c = torch.cat(codes, dim=dim)
    return {kind: c, "scale": s}


def leaf_parts(leaf) -> List[torch.Tensor]:
    """The tensors of a plain or quantized leaf, in a fixed order."""
    if isinstance(leaf, dict):
        return [leaf[k] for k in sorted(leaf)]
    return [leaf]


def with_parts(leaf, tensors: Sequence[torch.Tensor]):
    if isinstance(leaf, dict):
        return dict(zip(sorted(leaf), tensors))
    return tensors[0]
