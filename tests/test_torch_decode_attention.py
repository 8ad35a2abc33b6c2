"""Ring decode attention (K1): the port's plain version against the JAX
kernel, run as the JAX package's own tests run it on the CPU (Pallas
interpret mode).

fp32 throughout, atol 1e-5. The CUDA kernel itself runs only on a card:
``tests/test_torch_cuda.py`` holds it against the plain version there.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from videollm_online_tpu.models.llama import _attention as jax_attention
from videollm_online_tpu.ops import decode_attention as jax_da

from videollm_online_tpu_torch.models.llama import _attention
from videollm_online_tpu_torch.ops import decode_attention as da
from videollm_online_tpu_torch.ops.auto import auto_attention

ATOL = 1e-5
B, HKV, G, D, C, L, LAYER = 2, 2, 4, 64, 1024, 2, 1


def _inputs(S, seed=0, quant=False, starts=(700, 37)):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, HKV * G, S, D).astype(np.float32)
    shape = (L, B, HKV, C, D)
    if quant:
        k = rng.randint(-127, 128, shape).astype(np.int8)
        v = rng.randint(-127, 128, shape).astype(np.int8)
        ks = (rng.rand(*shape[:-1]) / 64).astype(np.float32)
        vs = (rng.rand(*shape[:-1]) / 64).astype(np.float32)
    else:
        k = rng.randn(*shape).astype(np.float32)
        v = rng.randn(*shape).astype(np.float32)
        ks = vs = None
    q_pos = np.stack([s + np.arange(S) for s in starts]).astype(np.int32)
    return q, k, v, q_pos, ks, vs


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _jax_layered(q, k, v, q_pos, ks=None, vs=None, window=None):
    return np.asarray(jax_da.ring_decode_attention_layered(
        _j(q), _j(k), _j(v), _j(q_pos), jnp.asarray(LAYER, jnp.int32),
        window=window, interpret=True, k_scale=_j(ks), v_scale=_j(vs)))


def _port_layered(fn, q, k, v, q_pos, ks=None, vs=None, window=None):
    return fn(_t(q), _t(k), _t(v), _t(q_pos), LAYER, window=window,
              k_scale=_t(ks), v_scale=_t(vs)).numpy()


CASES = {
    # (S, window, int8 K/V)
    "decode": (1, None, False),
    "burst": (14, None, False),
    "verify": (20, None, False),
    "window_decode": (1, 96, False),
    "window_verify": (20, 96, False),
    "int8_decode": (1, None, True),
    "int8_verify": (20, None, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layered_plain_matches_jax_kernel(case):
    S, window, quant = CASES[case]
    q, k, v, q_pos, ks, vs = _inputs(S, quant=quant)
    want = _jax_layered(q, k, v, q_pos, ks, vs, window=window)
    for fn in (da.ring_decode_attention_layered_reference,
               da.ring_decode_attention_layered):   # CPU tensor: plain path
        got = _port_layered(fn, q, k, v, q_pos, ks, vs, window=window)
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("S", [1, 20])
def test_single_layer_form_matches_jax_kernel(S):
    q, k, v, q_pos, _, _ = _inputs(S, seed=1)
    want = np.asarray(jax_da.ring_decode_attention(
        _j(q), _j(k[0]), _j(v[0]), _j(q_pos), interpret=True))
    for fn in (da.ring_decode_attention_reference, da.ring_decode_attention):
        got = fn(_t(q), _t(k[0]), _t(v[0]), _t(q_pos)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_stale_slots_past_q_pos_are_never_read(quant):
    """Whatever lies in the ring past each query's position (bucket
    padding, a rewound spec-verify step) must not change the output."""
    q, k, v, q_pos, ks, vs = _inputs(14, seed=2, quant=quant)
    want = _jax_layered(q, k, v, q_pos, ks, vs)
    k2, v2 = k.copy(), v.copy()
    for b in range(B):
        end = q_pos[b].max() + 1
        k2[:, b, :, end:] = 100 if quant else 1e4
        v2[:, b, :, end:] = -100 if quant else -1e4
    got = _port_layered(da.ring_decode_attention_layered_reference,
                        q, k2, v2, q_pos, ks, vs)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_row_with_nothing_visible_is_zero():
    q, k, v, q_pos, _, _ = _inputs(1, seed=3)
    q_pos[1] = -1
    want = _jax_layered(q, k, v, q_pos)
    got = _port_layered(da.ring_decode_attention_layered_reference,
                        q, k, v, q_pos)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert not got[1].any()


@pytest.mark.parametrize("S,window,quant", [(91, None, False),
                                            (20, 96, False),
                                            (91, None, True)])
def test_plain_attention_matches_jax(S, window, quant):
    """Chunks over 64 tokens (the 8-frame ingest) take the plain path, the
    counterpart of the JAX package's XLA ``_attention``."""
    q, k, v, q_pos, ks, vs = _inputs(S, seed=4, quant=quant)
    kw_j = {} if ks is None else {"k_scale": _j(ks[LAYER]),
                                  "v_scale": _j(vs[LAYER])}
    kw_t = {} if ks is None else {"k_scale": _t(ks[LAYER]),
                                  "v_scale": _t(vs[LAYER])}
    want = jax_attention(_j(q), _j(k[LAYER]), _j(v[LAYER]), _j(q_pos), None,
                         num_groups=G, sliding_window=window, **kw_j)
    got = _attention(_t(q), _t(k[LAYER]), _t(v[LAYER]), _t(q_pos), None,
                     num_groups=G, sliding_window=window, **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    got = auto_attention.layered(_t(q), _t(k), _t(v), _t(q_pos), LAYER,
                                 num_groups=G, sliding_window=window, **{
                                     n: None if t is None else _t(t)
                                     for n, t in (("k_scale", ks),
                                                  ("v_scale", vs))})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_kernel_rejects_what_it_does_not_take():
    q, k, v, q_pos, _, _ = _inputs(1)
    with pytest.raises(ValueError, match="CUDA"):
        da._launch(_t(q), _t(k), _t(v), _t(q_pos), LAYER, None, None, None)
