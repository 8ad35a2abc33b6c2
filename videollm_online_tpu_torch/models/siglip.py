"""Functional SigLIP ViT encoder (google/siglip-large-patch16-384 family), in
PyTorch.

Counterpart of ``videollm_online_tpu/models/siglip.py`` (reference
models/vision_live.py:10-30): the patch embedding as one matmul over
channel-major patches, a pre-LN transformer, the post-LN, the
attention-pooling head (``pooler_output``) and the frame-feature epilogue
that gives CLS + adaptive-average-pooled spatial tokens (1 + 3 x 3 = 10
tokens of 1024 dims a frame for live1+).

Attention is plain ops with an fp32 softmax, as the JAX package computes it
(XLA einsums there, no kernel): at T 577, d 64 a flash kernel did not pay on
the TPU, and the matmuls carry about 91 % of the encoder's FLOPs. Weights
and activations are in ``cfg.dtype``; layer norms and the softmax run in
fp32.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import LiveConfig, VisionConfig
from ..core.device import resolve_device, torch_dtype

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init


def _linear_init(generator, din, dout, dtype, device):
    lim = 1.0 / math.sqrt(din)
    u = torch.rand((din, dout), generator=generator, device=device)
    return {"w": ((u * 2.0 - 1.0) * lim).to(dtype),
            "b": torch.zeros((dout,), dtype=dtype, device=device)}


def _ln_init(dim, dtype, device):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def _normal(generator, shape, std, dtype, device):
    return (torch.randn(shape, generator=generator, device=device)
            * std).to(dtype)


def _stack(trees):
    """A list of identical dict trees -> one tree of stacked leaves."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_layers(generator, cfg: VisionConfig, dtype, device) -> Params:
    D, F_ = cfg.hidden_size, cfg.intermediate_size

    def layer():
        return {"ln1": _ln_init(D, dtype, device),
                "ln2": _ln_init(D, dtype, device),
                "q": _linear_init(generator, D, D, dtype, device),
                "k": _linear_init(generator, D, D, dtype, device),
                "v": _linear_init(generator, D, D, dtype, device),
                "o": _linear_init(generator, D, D, dtype, device),
                "fc1": _linear_init(generator, D, F_, dtype, device),
                "fc2": _linear_init(generator, F_, D, dtype, device)}

    return _stack([layer() for _ in range(cfg.num_layers)])


def init_params(generator: torch.Generator, cfg: VisionConfig, device=None
                ) -> Params:
    """Random SigLIP weights in ``cfg.dtype``, drawn from ``generator``
    (which must live on ``device``): uniform(+-1/sqrt(fan_in)) linears,
    unit layer norms, N(0, 0.02) position embeddings and probe."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    D, F_ = cfg.hidden_size, cfg.intermediate_size
    patch_dim = 3 * cfg.patch_size * cfg.patch_size
    return {
        "patch_embed": _linear_init(generator, patch_dim, D, dtype, device),
        "pos_embed": _normal(generator, (cfg.num_patches, D), 0.02, dtype,
                             device),
        "layers": init_layers(generator, cfg, dtype, device),
        "post_ln": _ln_init(D, dtype, device),
        "head": {
            "probe": _normal(generator, (1, D), 0.02, dtype, device),
            "in_proj_w": _linear_init(generator, D, 3 * D, dtype, device)["w"],
            "in_proj_b": torch.zeros((3 * D,), dtype=dtype, device=device),
            "out_proj": _linear_init(generator, D, D, dtype, device),
            "ln": _ln_init(D, dtype, device),
            "fc1": _linear_init(generator, D, F_, dtype, device),
            "fc2": _linear_init(generator, F_, D, dtype, device),
        },
    }


# ---------------------------------------------------------------------------
# forward


def layer_norm(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    """LayerNorm in fp32, cast back to the activations' dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], p["scale"].float(),
                        p["bias"].float(), eps).to(x.dtype)


def linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    """x @ w + b with w stored (in, out); one launch, the bias in the
    product's epilogue."""
    return F.linear(x, p["w"].t(), p["b"])


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int
        ) -> torch.Tensor:
    """(B, Tq, D) x (B, Tk, D) -> (B, Tq, D): fp32 logits and softmax, the
    probabilities cast back to the activations' dtype."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    hd = D // num_heads
    q = q.reshape(B, Tq, num_heads, hd).transpose(1, 2)
    k = k.reshape(B, Tk, num_heads, hd).transpose(1, 2)
    v = v.reshape(B, Tk, num_heads, hd).transpose(1, 2)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(probs, v)
    return out.transpose(1, 2).reshape(B, Tq, D)


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """NCHW pixels -> (B, num_patches, C * patch * patch), channel-major per
    patch (a Conv2d weight's flattening)."""
    B, C, H, W = pixels.shape
    gh, gw = H // patch, W // patch
    x = pixels.reshape(B, C, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, gh * gw, C * patch * patch)


def encoder_layer(h: torch.Tensor, lp: Params, cfg: VisionConfig, act
                  ) -> torch.Tensor:
    """One pre-LN block: attention then MLP, each with its residual."""
    y = layer_norm(h, lp["ln1"], cfg.layer_norm_eps)
    attn = mha(linear(y, lp["q"]), linear(y, lp["k"]), linear(y, lp["v"]),
               cfg.num_heads)
    h = h + linear(attn, lp["o"])
    y = layer_norm(h, lp["ln2"], cfg.layer_norm_eps)
    return h + linear(act(linear(y, lp["fc1"])), lp["fc2"])


def index_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def _gelu_tanh(y):
    return F.gelu(y, approximate="tanh")


def encode(params: Params, pixels: torch.Tensor, cfg: VisionConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pixels (B, 3, H, W), already normalized -> (last_hidden_state
    (B, P, D), pooler_output (B, D))."""
    dtype = params["pos_embed"].dtype
    x = linear(patchify(pixels.to(dtype), cfg.patch_size),
               params["patch_embed"])
    x = x + params["pos_embed"][None]
    for i in range(params["layers"]["q"]["w"].shape[0]):
        x = encoder_layer(x, index_tree(params["layers"], i), cfg, _gelu_tanh)
    x = layer_norm(x, params["post_ln"], cfg.layer_norm_eps)
    return x, attention_pool(params["head"], x, cfg)


def attention_pool(head: Params, hidden: torch.Tensor, cfg: VisionConfig
                   ) -> torch.Tensor:
    """SiglipMultiheadAttentionPoolingHead: a learned probe cross-attends
    the patch tokens, then LN + MLP with a residual; token 0."""
    B = hidden.shape[0]
    D = cfg.hidden_size
    probe = head["probe"][None].expand(B, 1, D).to(hidden.dtype)
    w, b = head["in_proj_w"], head["in_proj_b"]
    q = probe @ w[:, :D] + b[:D]
    k = hidden @ w[:, D:2 * D] + b[D:2 * D]
    v = hidden @ w[:, 2 * D:] + b[2 * D:]
    x = linear(mha(q, k, v, cfg.num_heads), head["out_proj"])
    y = layer_norm(x, head["ln"], cfg.layer_norm_eps)
    y = linear(_gelu_tanh(linear(y, head["fc1"])), head["fc2"])
    return (x + y)[:, 0]


# ---------------------------------------------------------------------------
# frame features (the live1 / live1+ token layout)


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, shape: tuple, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """A small constant on the device, copied there once (a copy from the
    host each call would stall every tick)."""
    return torch.tensor(values, dtype=dtype, device=device).reshape(shape)


def preprocess(frames_uint8: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    """uint8 NCHW -> normalized fp32 (vision_live.py:10-13)."""
    dev = frames_uint8.device
    mean = _constant(tuple(cfg.mean), (1, 3, 1, 1), torch.float32, dev)
    std = _constant(tuple(cfg.std), (1, 3, 1, 1), torch.float32, dev)
    x = frames_uint8.float() * cfg.rescale_factor
    return (x - mean) / std


def adaptive_pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) averaging matrix with torch adaptive_avg_pool1d bins:
    bin i covers [floor(i n / o), ceil((i + 1) n / o))."""
    m = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        start = (i * n_in) // n_out
        end = -(-(i + 1) * n_in // n_out)
        m[i, start:end] = 1.0 / (end - start)
    return m


def spatial_pool(last_hidden: torch.Tensor, out_hw: Tuple[int, int]
                 ) -> torch.Tensor:
    """adaptive_avg_pool2d of the patch grid (vision_live.py:16-23), as two
    averaging matmuls in the activations' dtype: (B, S * S, D) ->
    (B, oh * ow, D)."""
    B, P, D = last_hidden.shape
    s = int(math.isqrt(P))
    oh, ow = out_hw
    x = last_hidden.reshape(B, s, s, D)
    mh, mw = (_constant(tuple(adaptive_pool_matrix(s, o).ravel().tolist()),
                        (o, s), x.dtype, x.device) for o in (oh, ow))
    x = torch.einsum("hs,bswd->bhwd", mh, x)
    x = torch.einsum("wt,bhtd->bhwd", mw, x)
    return x.reshape(B, oh * ow, D)


def frame_features(params: Params, pixels: torch.Tensor, cfg: VisionConfig,
                   live_cfg: LiveConfig) -> torch.Tensor:
    """(B, 3, H, W) normalized pixels -> (B, tokens_per_frame, D):
    [CLS?, pooled spatial...] as vision_live.py:10-30 lays them out."""
    last_hidden, pooled = encode(params, pixels, cfg)
    parts = []
    if live_cfg.frame_token_cls:
        parts.append(pooled[:, None])
    if live_cfg.frame_token_pooled:
        parts.append(spatial_pool(last_hidden,
                                  tuple(live_cfg.frame_token_pooled)))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
