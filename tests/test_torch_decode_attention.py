"""Ring decode attention (K1): the port's plain version against the JAX
kernel, run as the JAX package's own tests run it on the CPU (Pallas
interpret mode), and the kernels' schedule as the wrapper mirrors it.

fp32 cases at atol 1e-5. bf16 cases (bf16 q over bf16 or int8 K/V, the
card's main path) at the bounds of BF16_TOL, set above their readings on
this file's inputs. The CUDA kernel itself runs only on a card:
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

from _torch_schedule import SCHEDULE_S, check_schedule

ATOL = 1e-5
B, HKV, G, D, C, L, LAYER = 2, 2, 4, 64, 1024, 2, 1
# bf16 bounds: elementwise |got - want| <= atol + rtol |want| and the
# relative norm error |got - want| / |want| <= rel, over outputs whose
# median |want| is 0.04 to 0.13.
#  * "kernel": the plain version against the Pallas kernel. Both round P
#    to bf16 before P.V, but the kernel rounds it against the running max
#    of its 512-slot blocks and the plain version against the row's max.
#    Readings: max error 9.8e-4, atol needed 3.0e-4 at rtol 2e-2, relative
#    norm 3.9e-4.
#  * "xla": against the JAX package's XLA attention (models/llama.py
#    _attention), which rounds the normalised probabilities (not P) to
#    bf16, and for int8 K/V the dequantised K/V. Readings: max error
#    7.8e-3, atol needed 1.9e-3 at rtol 2e-2, relative norm 4.1e-3.
BF16_TOL = {"kernel": dict(atol=1e-3, rtol=2e-2, rel=1e-3),
            "xla": dict(atol=4e-3, rtol=2e-2, rel=6e-3)}


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


def _t(x, bf16=False):
    if x is None:
        return None
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if bf16 and t.is_floating_point() else t


def _j(x, bf16=False):
    if x is None:
        return None
    a = jnp.asarray(x)
    return a.astype(jnp.bfloat16) if bf16 and x.dtype == np.float32 else a


def _held(got, want, tol):
    """got against want at one of BF16_TOL's bounds."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=tol["atol"], rtol=tol["rtol"])
    assert (np.linalg.norm(got - want) / np.linalg.norm(want)
            <= tol["rel"])


def _jax_layered(q, k, v, q_pos, ks=None, vs=None, window=None):
    return np.asarray(jax_da.ring_decode_attention_layered(
        _j(q), _j(k), _j(v), _j(q_pos), jnp.asarray(LAYER, jnp.int32),
        window=window, interpret=True, k_scale=_j(ks), v_scale=_j(vs)))


def _port_layered(fn, q, k, v, q_pos, ks=None, vs=None, window=None):
    return fn(_t(q), _t(k), _t(v), _t(q_pos), LAYER, window=window,
              k_scale=_t(ks), v_scale=_t(vs)).numpy()


CASES = {
    # (S, window, int8 K/V[, bf16 q and K/V])
    "decode": (1, None, False),
    "burst": (14, None, False),
    "verify": (20, None, False),
    "window_decode": (1, 96, False),
    "window_verify": (20, 96, False),
    "int8_decode": (1, None, True),
    "int8_verify": (20, None, True),
    "bf16_decode": (1, None, False, True),
    "bf16_verify": (21, None, False, True),
    "bf16_int8_decode": (1, None, True, True),
    "bf16_int8_window_burst": (7, 100, True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layered_plain_matches_jax_kernel(case):
    S, window, quant, *bf16 = CASES[case]
    q, k, v, q_pos, ks, vs = _inputs(S, quant=quant)
    if not bf16:
        want = _jax_layered(q, k, v, q_pos, ks, vs, window=window)
        for fn in (da.ring_decode_attention_layered_reference,
                   da.ring_decode_attention_layered):  # CPU: plain path
            got = _port_layered(fn, q, k, v, q_pos, ks, vs, window=window)
            np.testing.assert_allclose(got, want, atol=ATOL)
        return
    jq, jk, jv = (_j(x, bf16=True) for x in (q, k, v))
    want = jax_da.ring_decode_attention_layered(
        jq, jk, jv, _j(q_pos), jnp.asarray(LAYER, jnp.int32), window=window,
        interpret=True, k_scale=_j(ks), v_scale=_j(vs))
    kw = {} if ks is None else {"k_scale": _j(ks[LAYER]),
                                "v_scale": _j(vs[LAYER])}
    want_xla = jax_attention(jq, jk[LAYER], jv[LAYER], _j(q_pos), None,
                             num_groups=G, sliding_window=window, **kw)
    for fn in (da.ring_decode_attention_layered_reference,
               da.ring_decode_attention_layered):
        got = fn(*(_t(x, bf16=True) for x in (q, k, v)), _t(q_pos), LAYER,
                 window=window, k_scale=_t(ks), v_scale=_t(vs))
        assert got.dtype == torch.bfloat16
        _held(got.float(), want.astype(jnp.float32), BF16_TOL["kernel"])
        _held(got.float(), want_xla.astype(jnp.float32), BF16_TOL["xla"])


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


# ------------------------------------------------- the kernels' schedule
@pytest.mark.parametrize("design", da.DESIGNS)
@pytest.mark.parametrize("S", SCHEDULE_S)
def test_schedule_covers_each_visible_tile_once(design, S):
    """K1's schedule as ops/decode_attention.py mirrors the CUDA source:
    rings of 1000 and 2048 slots, ragged offsets (none visible, the first
    slot, tile edges, mid-ring, past the ring's end), windows off and on
    (edges inside a tile), 1 split, 3, and the wrapper's count at the 8B
    shapes on 132 SMs; the row blocks cover all G * S rows."""
    for g in (1, 4, 8):
        rows = g * S
        slices, per, nblk = da.row_blocks(design, rows)
        assert per * (nblk - 1) < rows <= per * nblk
        if design == "tensor cores":
            assert slices == (4 if rows <= 16 else 1)
            assert per == {1: 128, 4: 16}[slices]
        else:
            assert (slices, per) == (1, da.FMA_ROWS_PER_CTA)
    for slots in (1000, 2048):
        nsplits = {1, 3, da.num_splits(design, 132, 1, 8, 4 * S, slots)}
        for window in (None, 40, 100, 300):
            for off in (-S, 0, 37, 63, 64, 700, 1500, 2100):
                q_pos = [off + i for i in range(S)]
                for nsplit in nsplits:
                    check_schedule(design, q_pos, window, slots, nsplit)
