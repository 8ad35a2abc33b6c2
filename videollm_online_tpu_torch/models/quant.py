"""Weight-only int8 / int4 quantization for serving.

Counterpart of ``videollm_online_tpu/models/quant.py``; the byte layouts
are the JAX package's, so quantized parameters cross ``models/bridge.py``
unchanged. A quantized matrix is a dict that
``models.llama.dense``/``embed_tokens``/``lm_head`` accept:

  int8: ``{"q8": int8 (in, out), "scale": fp32 (out,)}``, one scale per
        output channel (the embedding table keeps one per row);
  int4, row-packed: ``{"q4p": int8 (in/2, out), "scale": fp32 (in/group,
        out)}``: byte ``i`` holds row ``i`` in its low nibble and row
        ``i + in/2`` in its high nibble, both signed;
  int4, column-packed: ``{"q4c": int8 (in, out/2), "scale": fp32
        (in/group, out)}``: byte ``(k, j)`` is ``16 * q[k, j + out/2] +
        (q[k, j] + 8)``, a signed high nibble and a low nibble biased by 8.

``bits=4`` gives the mixed serving layout: the MLP matrices and ``lm_head``
column-packed int4 (the matrices the kernels of ``ops/fused_mlp.py`` read),
attention and the embedding int8.

``quantized_matmul`` is the route the kernels' dispatch declines to: plain
``torch.matmul`` over a dequantized copy of the weight (the JAX package
leaves it to XLA, which fuses the conversion into the matmul; PyTorch eager
does not, so every call builds the copy; a W8A16 kernel is later work). A
``q4c`` leaf first tries ``ops.fused_mlp.maybe_matmul_int4c``, which on a
CUDA tensor of at most 128 rows launches the kernel. The int8 form is
differentiable with respect to ``x`` only (the int8 base is frozen), and
its backward keeps the int8 codes and the scale, never the cast copy: at 8B
a kept bf16 copy of every frozen matrix would be 16 GB.

``quantized_matmul(..., tile_cols)`` (with ``head_tile_cols``; the JAX
package's ``quantized_matmul_tiled``) is the int8 product one
output-column tile at a time, for the head of the chunked CE loss and
of the evaluator's chunked stats: the untiled int8 path casts the whole
(in, out) matrix to x's dtype on every call, forward and backward, which
for the 8B head (4096 x 128256) is a 1002 MiB copy in each chunk; a tile
of 21376 columns casts 167 MiB. Each output column still reduces over the
whole ``in`` axis, so the forward equals the untiled one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.device import resolve_device

QUANT_KEY = "q8"
QUANT4_KEY = "q4p"
QUANT4C_KEY = "q4c"
INT4_GROUP = 128  # reduction-dim group size for int4 scales


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and (QUANT_KEY in leaf or QUANT4_KEY in leaf
                                       or QUANT4C_KEY in leaf)


def quantize_weight(w: torch.Tensor, axis: int = 0) -> Dict[str, torch.Tensor]:
    """Symmetric per-channel int8 over the reduction ``axis``; codes are
    bit-identical to the JAX package's on the same fp32 input."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {QUANT_KEY: q, "scale": scale.squeeze(axis)}


def _quantize_groups(w: torch.Tensor, group: int):
    """Symmetric group-wise int4 values in [-7, 7] over the second-to-last
    (reduction) axis: (int8 values (..., in, out), fp32 scales
    (..., in/group, out)), bit-identical to the JAX package's."""
    *lead, d_in, d_out = w.shape
    group = min(group, d_in)   # small matrices: one group
    if d_in % group:
        raise ValueError(f"reduction dim {d_in} is not a multiple of the "
                         f"group {group}")
    wf = w.float().reshape(*lead, d_in // group, group, d_out)
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 7.0)
    q = torch.clamp(torch.round(wf / scale), -7, 7)
    return q.reshape(*lead, d_in, d_out).to(torch.int8), scale.squeeze(-2)


def _pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-7, 7] (..., in, out) -> (..., in/2, out) packed."""
    half = q.shape[-2] // 2
    lo = q[..., :half, :].to(torch.int32)
    hi = q[..., half:, :].to(torch.int32)
    return _wrap_int8((lo & 0x0F) | (hi << 4))


def _wrap_int8(v: torch.Tensor) -> torch.Tensor:
    """int32 -> int8 keeping the low 8 bits (two's complement wrap)."""
    return (((v & 0xFF) ^ 0x80) - 0x80).to(torch.int8)


def _unpack_nibbles(p: torch.Tensor, dtype) -> torch.Tensor:
    """(..., in/2, out) packed int8 -> (..., in, out) values in ``dtype``:
    both nibbles signed, lows are rows [0, in/2), highs [in/2, in)."""
    v = p.to(torch.int32)
    lo = ((v & 0x0F) ^ 8) - 8
    hi = v >> 4
    return torch.cat([lo, hi], dim=-2).to(dtype)


def _unpack_int4c(p: torch.Tensor, dtype) -> torch.Tensor:
    """(..., in, out/2) column-packed int8 -> (..., in, out) values in
    ``dtype``, right for every byte: hi = floor(byte / 16) in [-8, 7],
    lo = byte - 16 * hi - 8 in [-8, 7]."""
    v = p.to(torch.int32)
    hi = v >> 4
    lo = (v & 0x0F) - 8
    return torch.cat([lo, hi], dim=-1).to(dtype)


def quantize_weight_int4(w: torch.Tensor, group: int = INT4_GROUP
                         ) -> Dict[str, torch.Tensor]:
    """Row-packed group-wise int4 of (..., in, out): two reduction rows per
    byte (``_pack_nibbles``), scales (..., in/group, out) over the original
    row order."""
    if w.shape[-2] % 2:
        raise ValueError(f"reduction dim {w.shape[-2]} must be even")
    q, scale = _quantize_groups(w, group)
    return {QUANT4_KEY: _pack_nibbles(q), "scale": scale}


def quantize_weight_int4c(w: torch.Tensor, group: int = INT4_GROUP
                          ) -> Dict[str, torch.Tensor]:
    """Column-packed group-wise int4 of (..., in, out): byte ``(k, j)`` is
    ``16 * q[k, j + out/2] + (q[k, j] + 8)``."""
    d_out = w.shape[-1]
    if d_out % 2:
        raise ValueError(f"output dim {d_out} must be even")
    q, scale = _quantize_groups(w, group)
    q = q.to(torch.int32)
    packed = 16 * q[..., d_out // 2:] + (q[..., : d_out // 2] + 8)
    return {QUANT4C_KEY: packed.to(torch.int8), "scale": scale}


def _scale_groups(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Values (..., in, out) in ``dtype`` times their group scales cast to
    ``dtype`` (the JAX package's order: the product is rounded in
    ``dtype``)."""
    *lead, d_in, d_out = q.shape
    n_groups = scale.shape[-2]
    wf = q.reshape(*lead, n_groups, d_in // n_groups, d_out)
    wf = wf * scale[..., :, None, :].to(dtype)
    return wf.reshape(*lead, d_in, d_out)


def _dequantize_int4c(qw: Dict[str, torch.Tensor], dtype) -> torch.Tensor:
    return _scale_groups(_unpack_int4c(qw[QUANT4C_KEY], dtype), qw["scale"],
                         dtype)


def _dequantize_int4(qw: Dict[str, torch.Tensor], dtype) -> torch.Tensor:
    return _scale_groups(_unpack_nibbles(qw[QUANT4_KEY], dtype), qw["scale"],
                         dtype)


def dequantize_weight(qw: Dict[str, torch.Tensor], axis: int = 0,
                      dtype=torch.bfloat16) -> torch.Tensor:
    if QUANT4C_KEY in qw:
        return _dequantize_int4c(qw, torch.float32).to(dtype)
    if QUANT4_KEY in qw:
        return _dequantize_int4(qw, torch.float32).to(dtype)
    scale = qw["scale"].unsqueeze(axis)
    return (qw[QUANT_KEY].float() * scale).to(dtype)


def head_tile_cols(v: int, max_tile: int = 32768) -> Optional[int]:
    """The largest multiple of 128 that divides ``v`` and is at most
    ``max_tile``: the column tile of ``quantized_matmul`` for a head of
    ``v`` columns (None when ``v`` fits in one tile). 21376 (6 tiles) for
    Llama-3's 128256."""
    if v <= max_tile:
        return None
    best = None
    for d in range(128, max_tile + 1, 128):
        if v % d == 0:
            best = d
    return best


def _tiles(v: int, tile_cols: Optional[int]):
    step = tile_cols or v
    return [(c, min(c + step, v)) for c in range(0, v, step)]


def _qmm(x, q8, scale, tile_cols: Optional[int] = None):
    """x @ q8, then * scale, one ``tile_cols`` column tile at a time (None:
    one tile of the whole width), each tile casting only its own slice."""
    v = q8.shape[-1]
    if not tile_cols or tile_cols >= v:
        return (x @ q8.to(x.dtype)) * scale.to(x.dtype)
    out = x.new_empty(*x.shape[:-1], v)
    for c0, c1 in _tiles(v, tile_cols):
        out[..., c0:c1] = _qmm(x, q8[:, c0:c1], scale[c0:c1])
    return out


class _QuantizedMatmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, q8, scale, tile_cols):
        ctx.save_for_backward(q8, scale)
        ctx.tile_cols = tile_cols
        return _qmm(x, q8, scale, tile_cols)

    @staticmethod
    def backward(ctx, g):
        # what JAX's autodiff of (x @ w) * s gives: (g * s) @ w^T in g's
        # dtype, one tile's cast copy at a time; several tiles' parts are
        # summed in fp32 and rounded once to g's dtype
        q8, scale = ctx.saved_tensors
        dx = None
        for c0, c1 in _tiles(q8.shape[-1], ctx.tile_cols):
            part = (g[..., c0:c1] * scale[c0:c1].to(g.dtype)) @ \
                q8[:, c0:c1].to(g.dtype).transpose(-1, -2)
            dx = part if dx is None else dx.float() + part.float()
        return dx.to(g.dtype), None, None, None


def quantized_matmul(x: torch.Tensor, qw: Dict[str, torch.Tensor],
                     tile_cols: Optional[int] = None) -> torch.Tensor:
    """x (.., in) @ the quantized (in, out) matrix, in x's dtype.

    int8: x @ q8, then * scale (out,), in that order (the JAX epilogue
    order); with ``tile_cols`` (the JAX package's
    ``quantized_matmul_tiled``) one output-column tile at a time, the last
    tile possibly narrower, as a rank's slice of a tensor-parallel head
    is, and the tiles joined on the last dim. Differentiable in x, the
    backward keeping the codes and the scale and casting one tile at a
    time too; calls that autograd does not record (serving) skip the
    Function's per-call host cost. ``q4c``: the kernel where
    ``maybe_matmul_int4c`` dispatches it, else, like ``q4p``, x @ the
    matrix dequantized in x's dtype (``tile_cols`` ignored)."""
    if QUANT4C_KEY in qw:
        from ..ops.fused_mlp import maybe_matmul_int4c
        y = maybe_matmul_int4c(x, qw)
        if y is not None:
            return y.to(x.dtype)
        return x @ _dequantize_int4c(qw, x.dtype)
    if QUANT4_KEY in qw:
        return x @ _dequantize_int4(qw, x.dtype)
    if torch.is_grad_enabled() and x.requires_grad:
        return _QuantizedMatmul.apply(x, qw[QUANT_KEY], qw["scale"],
                                      tile_cols)
    return _qmm(x, qw[QUANT_KEY], qw["scale"], tile_cols)


# The int4 serving layout: column-packed int4 for the matrices the fused
# kernels read (the MLP, three quarters of a layer's weight bytes, and the
# lm_head); q/k/v/o and the embedding (read by gather) stay int8.
_INT4C_MATS = ("w_gate", "w_up", "w_down")


def quantize_llama_params(params: Dict[str, Any], bits: int = 8
                          ) -> Dict[str, Any]:
    """Quantize every big decoder matrix; norms and biases pass through.
    ``bits`` = 8 (per-channel int8) or 4 (the mixed int4 serving layout:
    MLP and lm_head column-packed int4, attention and embedding int8)."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")

    def int8_mat(w):
        return quantize_weight(w, axis=-2)

    out = {"embed": quantize_weight(params["embed"], axis=1),
           "final_norm": params["final_norm"]}
    layers = {}
    for name, w in params["layers"].items():
        if name in ("attn_norm", "mlp_norm", "bq", "bk", "bv"):
            layers[name] = w
        elif bits == 4 and name in _INT4C_MATS:
            layers[name] = quantize_weight_int4c(w)
        else:
            layers[name] = int8_mat(w)
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"] = (quantize_weight_int4c(params["lm_head"])
                          if bits == 4 else int8_mat(params["lm_head"]))
    return out


def quantize_live_params(params: Dict[str, Any], bits: int = 8
                         ) -> Dict[str, Any]:
    out = dict(params)
    out["llama"] = quantize_llama_params(params["llama"], bits=bits)
    return out


def random_quantized_llama_params(generator: torch.Generator, cfg,
                                  bits: int = 8, device=None
                                  ) -> Dict[str, Any]:
    """An int8 (``bits`` = 8) or mixed int4 (``bits`` = 4) decoder with
    random codes, built directly on ``device`` from ``generator`` (which
    must live on that device): no full-width staging copy exists at any
    point. Any byte is valid column-packed int4 data, so the ``q4c``
    matrices are random bytes over the whole int8 range."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    device = resolve_device(device)
    L, D, F = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size

    def codes(shape, low=-127):
        return torch.randint(low, 128, shape, dtype=torch.int8,
                             generator=generator, device=device)

    def qrand8(shape, fan_in):
        scale = torch.full(shape[:-2] + (shape[-1],),
                           0.02 / 127.0 / np.sqrt(fan_in / D),
                           dtype=torch.float32, device=device)
        return {QUANT_KEY: codes(shape), "scale": scale}

    def qrand4c(shape, fan_in):
        n_groups = max(shape[-2] // INT4_GROUP, 1)
        scale = torch.full(shape[:-2] + (n_groups, shape[-1]),
                           0.02 / 7.0 / np.sqrt(fan_in / D),
                           dtype=torch.float32, device=device)
        return {QUANT4C_KEY: codes(shape[:-1] + (shape[-1] // 2,), low=-128),
                "scale": scale}

    def qrand(shape, fan_in, name):
        if bits == 4 and (name in _INT4C_MATS or name == "lm_head"):
            return qrand4c(shape, fan_in)
        return qrand8(shape, fan_in)

    dims = {
        "wq": (D, cfg.q_dim), "wk": (D, cfg.kv_dim), "wv": (D, cfg.kv_dim),
        "wo": (cfg.q_dim, D), "w_gate": (D, F), "w_up": (D, F),
        "w_down": (F, D),
    }
    bf16 = dict(dtype=torch.bfloat16, device=device)
    layers = {"attn_norm": torch.ones((L, D), **bf16),
              "mlp_norm": torch.ones((L, D), **bf16)}
    for name, (din, dout) in dims.items():
        layers[name] = qrand((L, din, dout), din, name)
    if cfg.attention_bias:
        layers["bq"] = torch.zeros((L, cfg.q_dim), **bf16)
        layers["bk"] = torch.zeros((L, cfg.kv_dim), **bf16)
        layers["bv"] = torch.zeros((L, cfg.kv_dim), **bf16)
    V = cfg.vocab_size
    return {
        "embed": {QUANT_KEY: codes((V, D)),
                  "scale": torch.full((V,), 0.02 / 127.0,
                                      dtype=torch.float32, device=device)},
        "layers": layers,
        "final_norm": torch.ones((D,), **bf16),
        "lm_head": qrand((D, V), D, "lm_head"),
    }


def param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()
